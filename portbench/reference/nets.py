"""Plain float32 networks of the configurations: the Nature-DQN torso
(Mnih et al. 2015, Methods) with a Q head, and the IQN head on the same
torso (Dabney et al. 2018, eq. 4: ψ(x) ⊙ φ(τ), φ_j(τ) = ReLU(Σ_i cos(π i τ)
w_ij + b_j), then f).

Parameters are a dict of tensors keyed by the names the benchmark gives
them (``conv0.weight`` …); the reference owns these names and their
shapes, and the driver loads the same tensors into the program.  Inputs
are uint8 stacks ``[B, 4, 84, 84]``, oldest frame first, scaled by 1/255.
``rnd`` rounds the operands of every product (:mod:`.precision`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def torso_shapes(cfg: dict, prefix: str = "") -> List[Tuple[str, tuple]]:
    """The torso's parameters: three convolutions and the 512-wide fc."""
    t = cfg["torso"]
    out, c_in, hw = [], t["stack"], t["frame"][0]
    for i, (c, k, s) in enumerate(t["conv"]):
        out += [(f"{prefix}conv{i}.weight", (c, c_in, k, k)),
                (f"{prefix}conv{i}.bias", (c,))]
        c_in, hw = c, (hw - k) // s + 1
    out += [(f"{prefix}fc0.weight", (t["fc"], c_in * hw * hw)),
            (f"{prefix}fc0.bias", (t["fc"],))]
    return out


def torso(p: Params, x: torch.Tensor, cfg: dict, rnd, prefix: str = ""):
    """``[B, 4, 84, 84]`` uint8 → ``[B, 512]`` after the fc's ReLU."""
    h = x.float() / 255.0
    for i, (_, _, s) in enumerate(cfg["torso"]["conv"]):
        w, b = p[f"{prefix}conv{i}.weight"], p[f"{prefix}conv{i}.bias"]
        h = F.relu(F.conv2d(rnd(h), rnd(w), b, stride=s))
    h = h.flatten(1)
    return F.relu(F.linear(rnd(h), rnd(p[f"{prefix}fc0.weight"]),
                           p[f"{prefix}fc0.bias"]))


def fan_in(shape: tuple) -> int:
    return int(math.prod(shape[1:]))


# -- DQN ----------------------------------------------------------------------
def dqn_shapes(cfg: dict):
    fc = cfg["torso"]["fc"]
    return torso_shapes(cfg) + [("fc1.weight", (cfg["n_actions"], fc)),
                                ("fc1.bias", (cfg["n_actions"],))]


def dqn_q(p: Params, x, cfg: dict, rnd) -> torch.Tensor:
    """Q values ``[B, A]``."""
    return F.linear(rnd(torso(p, x, cfg, rnd)), rnd(p["fc1.weight"]),
                    p["fc1.bias"])


# -- IQN ----------------------------------------------------------------------
def iqn_shapes(cfg: dict):
    h = cfg["agent"]
    fc, feat, n_cos = cfg["torso"]["fc"], h["feature_dim"], h["n_cos"]
    widths = [feat, *h["hidden"], cfg["n_actions"]]
    out = torso_shapes(cfg, "psi.") + [
        ("psi_proj.weight", (feat, fc)), ("psi_proj.bias", (feat,)),
        ("phi.weight", (feat, n_cos)), ("phi.bias", (feat,))]
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        out += [(f"f.{i}.weight", (b, a)), (f"f.{i}.bias", (b,))]
    return out


def iqn_z(p: Params, x, taus: torch.Tensor, cfg: dict, rnd, rnd_head
          ) -> torch.Tensor:
    """Quantile values ``[B, K, A]`` at fractions ``taus`` ``[B, K]``."""
    n_cos = cfg["agent"]["n_cos"]
    psi = F.relu(F.linear(rnd_head(torso(p, x, cfg, rnd, "psi.")),
                          rnd_head(p["psi_proj.weight"]), p["psi_proj.bias"]))
    i = torch.arange(1, n_cos + 1, dtype=torch.float32, device=taus.device)
    cos = torch.cos(taus[..., None] * math.pi * i)
    phi = F.relu(F.linear(rnd_head(cos), rnd_head(p["phi.weight"]),
                          p["phi.bias"]))
    z = psi[:, None, :] * phi
    n_f = sum(1 for k in p if k.startswith("f.") and k.endswith(".weight"))
    for j in range(n_f):
        z = F.linear(rnd_head(z), rnd_head(p[f"f.{j}.weight"]), p[f"f.{j}.bias"])
        if j < n_f - 1:
            z = F.relu(z)
    return z


SHAPES = {"dqn": dqn_shapes, "iqn": iqn_shapes}
