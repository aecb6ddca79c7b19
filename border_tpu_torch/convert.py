"""Carry weights and state over from the JAX package.

Every function takes what the JAX side holds, as numpy arrays or anything
``numpy.asarray`` reads (flax param dicts, ``flax.struct`` states), and
returns the port's counterpart on ``device`` (``None`` = the GPU, as for
every entry point of the port; the parameter converters return CPU state
dicts, which ``load_state_dict`` copies onto the module's device).  The module imports neither
``jax`` nor ``border_tpu``: it reads attributes and arrays only.

- AtariCNN params: conv kernels ``HWIO → OIHW``, Dense kernels
  ``[in, out] → [out, in]``, and ``Dense_0``'s 3136 input rows permuted from
  the JAX NHWC flatten order (``h·448 + w·64 + c``) to the port's NCHW
  order (``c·49 + h·7 + w``).
- MLP params: flax numbers its ``Dense_i`` in call order (the trunk, then
  the heads); ``IQNNet``'s ψ MLP comes first and the f-net's numbers go on
  from there, or, with a CNN ψ, the f-net is ``Dense_0``, ``Dense_1`` beside
  the named ``psi``, ``psi_proj`` and ``phi``.
- a critic ensemble's params, stacked by ``jax.vmap`` (a leading ``[n]`` on
  every leaf), are already :class:`EnsembleMLP`'s layout.
- SAC, BC, AWAC and IQL states: every network, ``log_alpha`` and the
  counters; the optimizers are fresh, and so must the JAX ones be.
- every game's state, ``PixelEnvState`` and ``VecEnvState`` → the port's env
  state, field by field (both sides are batched ``[N, ...]``).
- ``ReplayBufferState`` → the port's flat buffer state (``cursor`` and
  ``size`` become host ints).
- a DQN or IQN agent the JAX package saved with ``Agent.save`` (the
  ``.npz`` and the text of its ``PyTreeDef``): :func:`load_jax_policy`.
- ``FrameReplayState`` → the port's buffer state: the ``(R, 128)`` tile
  padding of each stored frame is stripped back to ``H × W``; the slice
  mode's mirror slots stay on the frames only; a PER state's ``tree``
  becomes a ``SumTreeState``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from border_tpu_torch.agents.awac import AWAC, AWACState
from border_tpu_torch.agents.bc import BC, BCState
from border_tpu_torch.agents.dqn import DQN, DQNState
from border_tpu_torch.agents.iql import IQL, IQLState
from border_tpu_torch.agents.iqn import IQN, IQNState
from border_tpu_torch.agents.sac import SAC, SACState
from border_tpu_torch.core.env import VecEnvState
from border_tpu_torch.envs import classic_control as cc
from border_tpu_torch.envs.breakout import BreakoutState
from border_tpu_torch.envs.freeway import FreewayState
from border_tpu_torch.envs.pixel import PixelEnvState
from border_tpu_torch.envs.pong import PongState
from border_tpu_torch.envs.reacher import ReacherState
from border_tpu_torch.envs.seaquest import SeaquestState
from border_tpu_torch.envs.space_invaders import SpaceInvadersState
from border_tpu_torch.models.cnn import AtariCNN
from border_tpu_torch.models.iqn import IQNNet
from border_tpu_torch.models.mlp import EnsembleMLP
from border_tpu_torch.replay.buffer import ReplayBufferState, Transition, map_obs
from border_tpu_torch.replay.frame_buffer import FrameReplayState
from border_tpu_torch.replay.sum_tree import SumTreeState
from border_tpu_torch.utils.counters import new_counts, set_counts
from border_tpu_torch.utils.device import DeviceLike, as_generator, resolve_device

_CNN_LAYERS = (("Conv_0", "conv0"), ("Conv_1", "conv1"), ("Conv_2", "conv2"),
               ("Dense_0", "fc0"), ("Dense_1", "fc1"))


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=resolve_device(device), dtype=dtype)


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


def _dense(p: Dict[str, Any], name: str, prefix: str,
           out: Dict[str, torch.Tensor]) -> None:
    """flax ``Dense`` ``p[name]`` → ``out[prefix.weight / prefix.bias]``."""
    k = np.asarray(p[name]["kernel"], np.float32)
    out[f"{prefix}.weight"] = torch.from_numpy(k.T.copy())
    out[f"{prefix}.bias"] = torch.from_numpy(
        np.asarray(p[name]["bias"], np.float32).copy())


def mlp_state_dict(net, flax_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``MLP`` / ``DuelingMLP`` / ``GaussianHeadMLP`` params → a state
    dict for the port's module ``net`` of the same class: ``Dense_i`` in
    call order are the trunk's layers, then the heads."""
    p = flax_params.get("params", flax_params)
    names = [f"layers.{i}" for i in range(len(net.layers))] + [
        n for n, m in net.named_children() if m in net.heads()]
    out: Dict[str, torch.Tensor] = {}
    for i, prefix in enumerate(names):
        _dense(p, f"Dense_{i}", prefix, out)
    return out


def iqn_net_state_dict(net: IQNNet,
                       flax_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``IQNNet`` params → a state dict for the port's ``net``."""
    p = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}
    n_psi = 0
    if net.psi is not None:
        for k, v in atari_cnn_state_dict(p["psi"]).items():
            out[f"psi.{k}"] = v
        _dense(p, "psi_proj", "psi_proj", out)
    else:
        n_psi = len(net.psi_mlp)
        for i in range(n_psi):
            _dense(p, f"Dense_{i}", f"psi_mlp.{i}", out)
    _dense(p, "phi", "phi", out)
    for i in range(len(net.f)):
        _dense(p, f"Dense_{n_psi + i}", f"f.{i}", out)
    return out


def ensemble_state_dict(net: EnsembleMLP,
                        flax_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Stacked flax ``MLP`` params (``[n, in, out]`` kernels, ``[n, out]``
    biases, from ``jax.vmap`` over ``init``) → a state dict for ``net``."""
    p = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(net.weights)):
        out[f"weights.{i}"] = torch.from_numpy(
            np.asarray(p[f"Dense_{i}"]["kernel"], np.float32).copy())
        out[f"biases.{i}"] = torch.from_numpy(
            np.asarray(p[f"Dense_{i}"]["bias"], np.float32).copy())
    return out


def net_state_dict(net, flax_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The converter that fits the port's module ``net``."""
    if isinstance(net, AtariCNN):
        return atari_cnn_state_dict(flax_params)
    if isinstance(net, IQNNet):
        return iqn_net_state_dict(net, flax_params)
    if isinstance(net, EnsembleMLP):
        return ensemble_state_dict(net, flax_params)
    return mlp_state_dict(net, flax_params)


def load_atari_cnn(net: AtariCNN, flax_params: Dict[str, Any]) -> AtariCNN:
    """Copy flax params into ``net`` in place; returns ``net``."""
    net.load_state_dict(atari_cnn_state_dict(flax_params))
    return net


def _check_fresh(*opt_states) -> None:
    count = max(_adam_count(o) for o in opt_states)
    if count:
        raise ValueError(
            f"optimizer state has taken {count} steps; only a fresh one "
            f"carries over"
        )


# the networks of each agent state, by field name
_NETS = {
    DQNState: ("params", "target_params"),
    IQNState: ("params", "target_params"),
    SACState: ("actor_params", "critic_params", "critic_target_params"),
    AWACState: ("actor_params", "critic_params", "critic_target_params"),
    IQLState: ("actor_params", "critic_params", "critic_target_params",
               "value_params"),
    BCState: ("params",),
}


def _agent_state(agent, jax_state, obs_space, act_space, device, *opt_names):
    """A fresh state of ``agent`` with the JAX state's networks and
    counters; the JAX optimizers named must be fresh."""
    device = resolve_device(device)
    _check_fresh(*(getattr(jax_state, n) for n in opt_names))
    st = agent.init(0, obs_space, act_space, device=device)
    for name in _NETS[type(st)]:
        net = getattr(st, name)
        net.load_state_dict(net_state_dict(net, getattr(jax_state, name)))
    set_counts(st, n_opts=int(np.asarray(jax_state.n_opts)),
               n_samples=int(np.asarray(jax_state.n_samples)))
    return st


def dqn_state(agent: DQN, jax_state, obs_space, act_space,
              device: DeviceLike = None) -> DQNState:
    """A ``DQNState`` with the JAX state's online and target params and
    counters, and a fresh optimizer (the JAX optimizer state must be fresh
    too: its moments are not carried over)."""
    return _agent_state(agent, jax_state, obs_space, act_space, device,
                        "opt_state")


def iqn_state(agent: IQN, jax_state, obs_space, act_space,
              device: DeviceLike = None) -> IQNState:
    """An ``IQNState`` with the JAX state's online and target params and
    counters, and a fresh optimizer (as :func:`dqn_state`)."""
    return _agent_state(agent, jax_state, obs_space, act_space, device,
                        "opt_state")


def sac_state(agent: SAC, jax_state, obs_space, act_space,
              device: DeviceLike = None) -> SACState:
    """A ``SACState`` with the JAX state's actor, critics, target critics,
    ``log_alpha`` and counters, and fresh optimizers."""
    st = _agent_state(agent, jax_state, obs_space, act_space, device,
                      "actor_opt", "critic_opt", "alpha_opt")
    with torch.no_grad():
        st.log_alpha.fill_(float(np.asarray(jax_state.log_alpha)))
    return st


def bc_state(agent: BC, jax_state, obs_space, act_space,
             device: DeviceLike = None) -> BCState:
    """A ``BCState`` with the JAX state's network and counters."""
    return _agent_state(agent, jax_state, obs_space, act_space, device,
                        "opt_state")


def awac_state(agent: AWAC, jax_state, obs_space, act_space,
               device: DeviceLike = None) -> AWACState:
    """An ``AWACState`` with the JAX state's networks and counters."""
    return _agent_state(agent, jax_state, obs_space, act_space, device,
                        "actor_opt", "critic_opt")


def iql_state(agent: IQL, jax_state, obs_space, act_space,
              device: DeviceLike = None) -> IQLState:
    """An ``IQLState`` with the JAX state's networks and counters."""
    return _agent_state(agent, jax_state, obs_space, act_space, device,
                        "actor_opt", "critic_opt", "value_opt")


def _adam_count(opt_state) -> int:
    """The largest ``count`` field anywhere in an optax state tuple."""
    if "count" in getattr(opt_state, "_fields", ()):
        return int(np.asarray(opt_state.count))
    if isinstance(opt_state, (tuple, list)):
        return max([_adam_count(s) for s in opt_state] + [0])
    return 0


def _copy_fields(cls, js, device):
    """A batched JAX state → the port's dataclass ``cls`` of the same field
    names, each field a tensor of the same dtype."""
    return cls(**{
        f.name: map_obs(lambda x: _t(x, device), getattr(js, f.name))
        for f in dataclasses.fields(cls)
    })


def _state_converter(cls):
    def convert_state(js, device: DeviceLike = None):
        return _copy_fields(cls, js, device)

    convert_state.__doc__ = (
        f"Batched JAX ``{cls.__name__}`` (a leading ``[N]`` axis on every "
        f"field) → the port's.")
    return convert_state


pong_state = _state_converter(PongState)
breakout_state = _state_converter(BreakoutState)
seaquest_state = _state_converter(SeaquestState)
freeway_state = _state_converter(FreewayState)
space_invaders_state = _state_converter(SpaceInvadersState)
cartpole_state = _state_converter(cc.CartPoleState)
pendulum_state = _state_converter(cc.PendulumState)
mountain_car_state = _state_converter(cc.MountainCarState)
acrobot_state = _state_converter(cc.AcrobotState)
reacher_state = _state_converter(ReacherState)

_ENV_STATES = {
    "PongState": pong_state, "BreakoutState": breakout_state,
    "SeaquestState": seaquest_state, "FreewayState": freeway_state,
    "SpaceInvadersState": space_invaders_state,
    "CartPoleState": cartpole_state, "PendulumState": pendulum_state,
    "MountainCarState": mountain_car_state, "AcrobotState": acrobot_state,
    "ReacherState": reacher_state,
}


def env_state(js, device: DeviceLike = None):
    """Any batched JAX env state → the port's, by the class's name."""
    name = type(js).__name__
    if name == "PixelEnvState":
        return pixel_env_state(js, device)
    return _ENV_STATES[name](js, device)


def pixel_env_state(js, device: DeviceLike = None) -> PixelEnvState:
    """Batched JAX ``PixelEnvState`` of any ported game → the port's."""
    return PixelEnvState(
        game=env_state(js.game, device),
        frames=_t(js.frames, device),
        frame_count=_t(js.frame_count, device, torch.int32),
        t=_t(js.t, device, torch.int32),
        lives=_t(js.lives, device, torch.int32),
        game_over=_t(js.game_over, device, torch.bool),
    )


def vec_env_state(js, seed_or_gen, device: DeviceLike = None) -> VecEnvState:
    """JAX ``VecEnvState`` → the port's.  The JAX key has no counterpart:
    the port's env draws from ``seed_or_gen``."""
    device = resolve_device(device)
    return VecEnvState(
        env_state=env_state(js.env_state, device),
        obs=map_obs(lambda x: _t(x, device), js.obs),
        episode_return=_t(js.episode_return, device, torch.float32),
        episode_length=_t(js.episode_length, device, torch.int32),
        last_return=_t(js.last_return, device, torch.float32),
        last_length=_t(js.last_length, device, torch.int32),
        gen=as_generator(seed_or_gen, device),
    )


def sum_tree_state(js, device: DeviceLike = None) -> SumTreeState:
    """JAX ``SumTreeState`` → the port's (same heap layout)."""
    return SumTreeState(
        sum_tree=_t(js.sum_tree, device, torch.float32),
        min_tree=_t(js.min_tree, device, torch.float32),
        max_priority=_t(js.max_priority, device, torch.float32),
    )


def frame_replay_state(js, frame_hw: Tuple[int, int] = (84, 84),
                       device: DeviceLike = None,
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
    total = int(np.asarray(js.total))
    return FrameReplayState(
        frames=_t(frames, device),
        act=_t(js.act, device, torch.int32)[:, :cap],
        reward=_t(js.reward, device, torch.float32)[:, :cap],
        terminated=_t(js.terminated, device, torch.bool)[:, :cap],
        truncated=_t(js.truncated, device, torch.bool)[:, :cap],
        age=_t(js.age, device, torch.int32)[:, :cap],
        total=total,
        tree=None if tree is None else sum_tree_state(tree, device),
        counts=new_counts(resolve_device(device), (total,)),
    )


def replay_state(js, device: DeviceLike = None) -> ReplayBufferState:
    """JAX ``ReplayBufferState`` of the flat buffer → the port's, with its
    tree when prioritized."""
    tree = getattr(js, "tree", None)
    cursor, size = int(np.asarray(js.cursor)), int(np.asarray(js.size))
    return ReplayBufferState(
        data=_copy_fields(Transition, js.data, device),
        cursor=cursor,
        size=size,
        tree=None if tree is None else sum_tree_state(tree, device),
        counts=new_counts(resolve_device(device), (cursor, size)),
    )


# -- a JAX-saved agent (``Agent.save``: <name>.npz + <name>.treedef.txt) ------

def _parse_treedef(text: str):
    """The structure of a ``str(PyTreeDef)``: dicts, lists, tuples, ``None``
    and ``("custom", name, children)`` for custom nodes (a flax struct, a
    namedtuple), with each leaf ``*`` replaced by its flatten index."""
    pos = 0
    n_leaves = 0

    def skip():
        nonlocal pos
        while pos < len(text) and text[pos] in " \n":
            pos += 1

    def expect(token):
        nonlocal pos
        skip()
        if not text.startswith(token, pos):
            raise ValueError(f"treedef: expected {token!r} at {pos}: "
                             f"{text[pos:pos + 40]!r}")
        pos += len(token)

    def balanced(open_, close):
        """The text up to the ``close`` that balances an ``open_`` read."""
        nonlocal pos
        depth, start = 1, pos
        while depth:
            if pos >= len(text):
                raise ValueError("treedef: unbalanced brackets")
            depth += {open_: 1, close: -1}.get(text[pos], 0)
            pos += 1
        return text[start:pos - 1]

    def items(close):
        out = []
        skip()
        while not text.startswith(close, pos):
            out.append(node())
            skip()
            if text.startswith(",", pos):
                expect(",")
                skip()
        expect(close)
        return out

    def node():
        nonlocal pos, n_leaves
        skip()
        if text.startswith("*", pos):
            pos += 1
            n_leaves += 1
            return n_leaves - 1
        if text.startswith("None", pos):
            pos += 4
            return None
        if text.startswith("CustomNode(", pos):
            pos += len("CustomNode(")
            name_end = text.index("[", pos)
            name = text[pos:name_end]
            pos = name_end + 1
            meta = balanced("[", "]")
            expect(",")
            expect("[")
            children = items("]")
            expect(")")
            # a namedtuple's custom node names its class in the metadata
            return ("custom", meta if name == "namedtuple" else name, children)
        if text.startswith("{", pos):
            pos += 1
            out = {}
            skip()
            while not text.startswith("}", pos):
                expect("'")
                key_end = text.index("'", pos)
                key = text[pos:key_end]
                pos = key_end + 1
                expect(":")
                out[key] = node()
                skip()
                if text.startswith(",", pos):
                    expect(",")
                    skip()
            expect("}")
            return out
        if text.startswith("[", pos):
            pos += 1
            return items("]")
        if text.startswith("(", pos):
            pos += 1
            return tuple(items(")"))
        raise ValueError(f"treedef: unexpected {text[pos:pos + 40]!r}")

    expect("PyTreeDef(")
    tree = node()
    expect(")")
    return tree, n_leaves


def _fill_leaves(tree, arrays):
    """``tree`` with each leaf index replaced by ``arrays[index]``."""
    if isinstance(tree, int):
        return arrays[tree]
    if isinstance(tree, dict):
        return {k: _fill_leaves(v, arrays) for k, v in tree.items()}
    raise ValueError(f"expected a parameter dict, found {type(tree).__name__}")


# the JAX agent states this loader knows: class name and its fields in order
_JAX_STATES = {
    "dqn": ("DQNState",
            ("params", "target_params", "opt_state", "n_opts", "n_samples")),
    "iqn": ("IQNState",
            ("params", "target_params", "opt_state", "n_opts", "n_samples")),
}


def load_jax_policy(agent, path: str, obs_space, act_space,
                    device: DeviceLike = None):
    """A state of the port's ``agent`` (DQN or IQN) with the networks and
    counters of an agent the JAX package saved with ``Agent.save``:
    ``<path>/<agent.name>.npz`` (positional ``arr_i``, in
    ``jax.tree.flatten`` order) and ``<path>/<agent.name>.treedef.txt``
    beside it, whose leaves are in the same order.

    Carries what acting needs: the online and target networks (each array
    checked against the port's template for its shape) and ``n_opts`` /
    ``n_samples``.  The optimizer is a fresh one; the JAX optimizer's
    moments are not read, so the state acts like the saved agent but does
    not go on training like it.  Raises ``ValueError`` on an agent or a
    saved layout it does not know."""
    if agent.name not in _JAX_STATES:
        raise ValueError(f"no JAX layout known for agent {agent.name!r} "
                         f"(known: {sorted(_JAX_STATES)})")
    cls_name, fields = _JAX_STATES[agent.name]
    with open(os.path.join(path, f"{agent.name}.treedef.txt")) as f:
        tree, n_leaves = _parse_treedef(f.read())
    if not (isinstance(tree, tuple) and len(tree) == 3 and tree[0] == "custom"
            and tree[1] == cls_name and len(tree[2]) == len(fields)):
        raise ValueError(f"{path}: the saved state is not a {cls_name} of "
                         f"fields {fields}")
    children = dict(zip(fields, tree[2]))
    with np.load(os.path.join(path, f"{agent.name}.npz")) as data:
        if len(data.files) != n_leaves:
            raise ValueError(f"{path}: {len(data.files)} arrays for "
                             f"{n_leaves} leaves of the treedef")
        arrays = [data[f"arr_{i}"] for i in range(n_leaves)]

    st = agent.init(0, obs_space, act_space, device=device)
    for name in ("params", "target_params"):
        net = getattr(st, name)
        template = net.state_dict()
        try:
            loaded = net_state_dict(net, _fill_leaves(children[name], arrays))
        except KeyError as e:
            raise ValueError(f"{path}: {name} lacks {e} of the port's "
                             f"{type(net).__name__}") from e
        if loaded.keys() != template.keys():
            raise ValueError(f"{path}: {name} holds {sorted(loaded)}, the "
                             f"port's {type(net).__name__} {sorted(template)}")
        for k, v in loaded.items():
            if v.shape != template[k].shape:
                raise ValueError(f"{path}: {name} {k} has shape "
                                 f"{tuple(v.shape)}, the port's "
                                 f"{tuple(template[k].shape)}")
        net.load_state_dict(loaded)
    for name in ("n_opts", "n_samples"):
        leaf = children[name]
        if not isinstance(leaf, int) or arrays[leaf].shape != ():
            raise ValueError(f"{path}: {name} is not a scalar leaf")
        set_counts(st, **{name: int(arrays[leaf])})
    return st
