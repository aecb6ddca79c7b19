"""The plain float32 Nature torso (Mnih et al. 2015, Methods), shared by
the agent kinds of :mod:`.kinds` that act on pixel stacks; each kind adds
its head.

Parameters are a dict of tensors keyed by the names the benchmark gives
them (``conv0.weight`` …); the reference owns these names and their
shapes, and the driver loads the same tensors into the program.  Inputs
are uint8 stacks ``[B, 4, 84, 84]``, oldest frame first, scaled by 1/255.
``rnd`` rounds the operands of every product (:mod:`.precision`).
"""

from __future__ import annotations

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
