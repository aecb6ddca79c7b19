"""Backend-free policy export: trained params → numpy-only inference
(≙ border_tpu/utils/export.py).

≙ border-policy-no-backend (hand-rolled Mat matmul/relu/tanh + Mlp,
mat.rs:1-130, mlp.rs:9-44; bincode serialization) and the convert_policy
example (examples/gym/convert_policy/src/main.rs:1-235): a trained policy is
converted to a dependency-free artifact (.npz + json meta) and executed with
plain numpy — no torch at inference time.

The artifact is the JAX package's, byte for byte in its arrays: the port's
modules are written in the flax layout (Dense kernels ``[in, out]``, conv
kernels HWIO, ``Dense_0``'s rows of the Atari CNN in the NHWC flatten order,
``Dense_i`` numbered in call order), so either package's
:class:`NumpyMLPPolicy` reads either package's export.  Besides the MLP
policies it exports DQN-on-AtariCNN (kind ``cnn_argmax``) and IQN (kind
``iqn_argmax`` — ψ features, cosine φ embedding, merge net, τ-averaged
argmax over a fixed const-K τ grid).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from border_tpu_torch.convert import atari_cnn_to_flax
from border_tpu_torch.models.cnn import AtariCNN
from border_tpu_torch.models.iqn import IQNNet

ACTS = {
    "relu": lambda x: np.maximum(x, 0.0),
    "tanh": np.tanh,
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "none": lambda x: x,
}

# AtariCNN's fixed conv scheme (models/cnn.py ≙ cnn/base.rs:23-99)
ATARI_CONV_STRIDES = (4, 2, 1)


def _inner(params: Dict[str, Any]) -> Dict[str, Any]:
    return params["params"] if "params" in params else params


def _sorted_layers(tree: Dict[str, Any], prefix: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    names = sorted(
        (k for k in tree if k.startswith(prefix)),
        key=lambda k: int(k.split("_")[1]),
    )
    return [
        (np.asarray(tree[n]["kernel"], np.float32),
         np.asarray(tree[n]["bias"], np.float32))
        for n in names
    ]


def _dense_layers(params: Dict[str, Any]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Flatten a flax MLP param dict into ordered (W, b) pairs."""
    return _sorted_layers(_inner(params), "Dense_")


def _conv_layers(params: Dict[str, Any]) -> List[Tuple[np.ndarray, np.ndarray]]:
    return _sorted_layers(_inner(params), "Conv_")


def _flax_dense(m: nn.Linear) -> Dict[str, np.ndarray]:
    return {"kernel": np.ascontiguousarray(m.weight.detach().cpu().numpy().T),
            "bias": m.bias.detach().cpu().numpy()}


def _flax_params(net: nn.Module) -> Dict[str, Any]:
    """The port's policy module as flax params (numpy, float32): the
    Atari CNN, an MLP (its trunk's ``Dense_i``, then its heads') or an
    ``IQNNet`` (a CNN ψ under ``psi`` beside ``psi_proj``, or the ψ MLP's
    Dense layers first; then ``phi`` and the merge net)."""
    if isinstance(net, AtariCNN):
        return atari_cnn_to_flax(net)
    if isinstance(net, IQNNet):
        p: Dict[str, Any] = {}
        denses: List[nn.Linear] = list(net.f)
        if net.psi is not None:
            p["psi"] = atari_cnn_to_flax(net.psi)["params"]
            p["psi_proj"] = _flax_dense(net.psi_proj)
        else:
            denses = [*net.psi_mlp, *denses]
        p["phi"] = _flax_dense(net.phi)
        for i, m in enumerate(denses):
            p[f"Dense_{i}"] = _flax_dense(m)
        return {"params": p}
    if hasattr(net, "heads"):
        return {"params": {f"Dense_{i}": _flax_dense(m)
                           for i, m in enumerate([*net.layers, *net.heads()])}}
    raise ValueError(f"export not supported for a {type(net).__name__}")


def _host(x) -> Any:
    """A tensor attribute of an agent (on any device) as numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def export_policy(agent, agent_state, path: str) -> str:
    """Write ``<path>/policy.npz`` + ``policy.json``; returns the dir.

    Supported policies:
    - DQN/BC on MLP: greedy argmax over Q logits (kind="argmax"),
    - DQN on AtariCNN: /255 + conv stack + dense head (kind="cnn_argmax"),
    - IQN (MLP or AtariCNN ψ): τ-averaged argmax (kind="iqn_argmax"),
    - SAC/AWAC/IQL: deterministic mean head with tanh|clamp limit
      (kind="gaussian_mean").
    """
    os.makedirs(path, exist_ok=True)
    params = _flax_params(agent.policy_params(agent_state))
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {"activation": "relu"}

    if agent.name == "iqn":
        meta.update(_export_iqn(agent, params, arrays))
    elif agent.name in ("dqn", "bc") and _conv_layers(params):
        convs = _conv_layers(params)
        denses = _dense_layers(params)
        meta.update(
            kind="cnn_argmax",
            conv_strides=list(ATARI_CONV_STRIDES[: len(convs)]),
            n_conv=len(convs),
            n_layers=len(denses),
            scale=1.0 / 255.0,
        )
        for i, (w, b) in enumerate(convs):
            arrays[f"cw{i}"], arrays[f"cb{i}"] = w, b
        for i, (w, b) in enumerate(denses):
            arrays[f"w{i}"], arrays[f"b{i}"] = w, b
    else:
        kind_map = {
            "dqn": "argmax",
            "bc": "argmax",
            "sac": "gaussian_mean",
            "awac": "gaussian_mean",
            "iql": "gaussian_mean",
        }
        kind = kind_map.get(agent.name)
        if kind is None:
            raise ValueError(f"export not supported for agent {agent.name!r}")
        layers = _dense_layers(params)
        meta.update(kind=kind, n_layers=len(layers))
        if kind == "gaussian_mean":
            # two-headed net: last two Dense are (mean, log_std) — keep mean
            hidden, mean_head = layers[:-2], layers[-2]
            layers = hidden + [mean_head]
            meta["n_layers"] = len(layers)
            limit = getattr(agent.config, "action_limit", "tanh")
            meta["limit"] = limit
            if agent.name == "sac":
                meta["scale"] = _host(agent.act_scale).tolist()
                meta["bias"] = _host(agent.act_bias).tolist()
            else:
                meta["low"] = agent.act_low
                meta["high"] = agent.act_high
        if agent.name == "bc" and agent.config.action_mode == "continuous":
            meta["kind"] = "identity"
        for i, (w, b) in enumerate(layers):
            arrays[f"w{i}"], arrays[f"b{i}"] = w, b

    np.savez(os.path.join(path, "policy.npz"), **arrays)
    with open(os.path.join(path, "policy.json"), "w") as f:
        json.dump(meta, f)
    return path


def _export_iqn(agent, params, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """IQN eval policy: argmax_a mean_k Z(obs, τ_k, a) over a const-K grid
    (≙ ε=0 acting path, border-tch-agent/src/iqn/base.rs:211-241)."""
    inner = _inner(params)
    strat = agent.config.sample_percents_act
    n_taus = 32
    if strat.startswith("const"):
        n_taus = int(strat[len("const"):])
    elif strat.startswith("uniform"):
        n_taus = int(strat[len("uniform"):])
    elif strat == "median":
        n_taus = 1

    meta: Dict[str, Any] = {
        "kind": "iqn_argmax",
        "n_taus": n_taus,
        "n_cos": int(agent.config.n_cos),
    }
    # ψ feature path
    if "psi" in inner:  # CNN ψ + psi_proj (models/iqn.py named modules)
        convs = _conv_layers(inner["psi"])
        psis = _sorted_layers(inner["psi"], "Dense_")
        meta["psi"] = {
            "cnn": True,
            "conv_strides": list(ATARI_CONV_STRIDES[: len(convs)]),
            "n_conv": len(convs),
            "n_dense": len(psis),
            "scale": 1.0 / 255.0,
        }
        for i, (w, b) in enumerate(convs):
            arrays[f"psi_cw{i}"], arrays[f"psi_cb{i}"] = w, b
        for i, (w, b) in enumerate(psis):
            arrays[f"psi_w{i}"], arrays[f"psi_b{i}"] = w, b
        pp = inner["psi_proj"]
        arrays["psi_proj_w"] = np.asarray(pp["kernel"], np.float32)
        arrays["psi_proj_b"] = np.asarray(pp["bias"], np.float32)
        meta["psi_proj"] = True
        merge = _sorted_layers(inner, "Dense_")
    else:
        # MLP ψ: first len(psi_hidden)+1 unnamed Denses belong to ψ, the
        # rest are the merge net (call order in IQNNet.__call__)
        all_dense = _sorted_layers(inner, "Dense_")
        n_psi = len(agent.config.hidden) + 1
        psis, merge = all_dense[:n_psi], all_dense[n_psi:]
        meta["psi"] = {"cnn": False, "n_dense": len(psis)}
        meta["psi_proj"] = False
        for i, (w, b) in enumerate(psis):
            arrays[f"psi_w{i}"], arrays[f"psi_b{i}"] = w, b
    # φ cosine embedding
    phi = inner["phi"]
    arrays["phi_w"] = np.asarray(phi["kernel"], np.float32)
    arrays["phi_b"] = np.asarray(phi["bias"], np.float32)
    meta["n_merge"] = len(merge)
    for i, (w, b) in enumerate(merge):
        arrays[f"w{i}"], arrays[f"b{i}"] = w, b
    return meta


def _np_conv2d(x: np.ndarray, w: np.ndarray, b: np.ndarray, stride: int) -> np.ndarray:
    """VALID-padding NHWC conv via strided im2col + one GEMM (numpy-only
    analogue of the reference's hand-rolled Mat matmul, mat.rs:1-130)."""
    kh, kw, cin, cout = w.shape
    B, H, W, C = x.shape
    oh = (H - kh) // stride + 1
    ow = (W - kw) // stride + 1
    s = x.strides
    patches = np.lib.stride_tricks.as_strided(
        x,
        (B, oh, ow, kh, kw, C),
        (s[0], s[1] * stride, s[2] * stride, s[1], s[2], s[3]),
    )
    out = patches.reshape(B, oh * ow, kh * kw * C) @ w.reshape(-1, cout)
    return out.reshape(B, oh, ow, cout) + b


class NumpyMLPPolicy:
    """Dependency-free policy runner (≙ pendulum_std example,
    examples/gym/pendulum_std/src/main.rs:115-173).  Handles every kind
    ``export_policy`` writes, including the CNN and IQN pixel policies."""

    def __init__(self, path: str):
        self.data = np.load(os.path.join(path, "policy.npz"))
        with open(os.path.join(path, "policy.json")) as f:
            self.meta = json.load(f)
        data = self.data
        n = self.meta.get("n_layers", self.meta.get("n_merge", 0))
        self.layers = [(data[f"w{i}"], data[f"b{i}"]) for i in range(n)]
        self.act = ACTS[self.meta["activation"]]

    def _dense_stack(self, x, layers, final_act=False):
        for i, (w, b) in enumerate(layers):
            x = x @ w + b
            if final_act or i < len(layers) - 1:
                x = self.act(x)
        return x

    def _cnn(self, x, prefix, strides, scale):
        x = np.asarray(x, np.float32) * scale
        for i, s in enumerate(strides):
            x = self.act(
                _np_conv2d(x, self.data[f"{prefix}cw{i}"],
                           self.data[f"{prefix}cb{i}"], s)
            )
        return x.reshape(x.shape[0], -1)

    def _iqn_q(self, x):
        m = self.meta
        psi_meta = m["psi"]
        if psi_meta["cnn"]:
            x = self._cnn(x, "psi_", psi_meta["conv_strides"], psi_meta["scale"])
        psi_layers = [
            (self.data[f"psi_w{i}"], self.data[f"psi_b{i}"])
            for i in range(psi_meta["n_dense"])
        ]
        # CNN ψ: every Dense is followed by relu (AtariCNN skip_linear);
        # MLP ψ: the last Dense feeds psi_proj-less relu too (models/iqn.py
        # applies act() after ψ in both branches)
        psi = self._dense_stack(x, psi_layers, final_act=True)
        if m.get("psi_proj"):
            psi = self.act(psi @ self.data["psi_proj_w"] + self.data["psi_proj_b"])
        K, n_cos = m["n_taus"], m["n_cos"]
        taus = (np.arange(K, dtype=np.float32) + 0.5) / K
        i = np.arange(1, n_cos + 1, dtype=np.float32)
        cos = np.cos(taus[:, None] * np.pi * i)  # [K, n_cos]
        phi = self.act(cos @ self.data["phi_w"] + self.data["phi_b"])  # [K, F]
        z = psi[:, None, :] * phi[None]  # [B, K, F]
        z = self._dense_stack(z, self.layers)
        return z.mean(axis=1)  # [B, A]

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        x = np.asarray(obs, np.float32)
        kind = self.meta["kind"]
        pixel = kind in ("cnn_argmax",) or (
            kind == "iqn_argmax" and self.meta["psi"]["cnn"]
        )
        squeeze = x.ndim == (3 if pixel else 1)
        if squeeze:
            x = x[None]
        if kind == "iqn_argmax":
            q = self._iqn_q(x)
            out = np.argmax(q, axis=-1).astype(np.int32)
        elif kind == "cnn_argmax":
            x = self._cnn(x, "", self.meta["conv_strides"], self.meta["scale"])
            x = self._dense_stack(x, self.layers)
            out = np.argmax(x, axis=-1).astype(np.int32)
        elif kind == "argmax":
            x = self._dense_stack(x, self.layers)
            out = np.argmax(x, axis=-1).astype(np.int32)
        elif kind == "gaussian_mean":
            x = self._dense_stack(x, self.layers)
            if self.meta.get("limit", "tanh") == "tanh":
                out = np.tanh(x)
                if "scale" in self.meta:
                    out = out * np.asarray(self.meta["scale"], np.float32) + np.asarray(
                        self.meta["bias"], np.float32
                    )
            else:
                out = np.clip(x, self.meta["low"], self.meta["high"])
        else:  # identity
            out = self._dense_stack(x, self.layers)
        return out[0] if squeeze else out
