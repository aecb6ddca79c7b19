"""The weights of a run, made from its seed on the device.

One normal draw for all parameters on a generator on the run's device,
cut into the tensors the reference names: weights are the truncated
(±2σ, clamped) LeCun normal of flax's initialisers, std 1/√fan-in,
biases are zero.  The benchmark hands the same tensors to the program
(the driver copies them into its modules) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# the std of a normal truncated at ±2σ is 0.8796 of the untruncated one
TRUNC_STD = 0.87962566103423978


def make(shapes: List[Tuple[str, tuple]], seed: int, device) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    weights = [(k, s) for k, s in shapes if len(s) > 1]
    total = sum(math.prod(s) for _, s in weights)
    flat = torch.randn((total,), generator=gen, device=device).clamp_(-2.0, 2.0)
    out, i = {}, 0
    for k, s in shapes:
        if len(s) == 1:
            out[k] = torch.zeros(s, device=device)
            continue
        n = math.prod(s)
        std = math.sqrt(1.0 / math.prod(s[1:])) / TRUNC_STD
        out[k] = (flat[i:i + n] * std).view(s)
        i += n
    return out
