"""DQN-paper CNN for pixel observations (≙ border_tpu/models/cnn.py).

conv 32×8s4 → 64×4s2 → 64×3s1 → fc(3136→512) → out, with /255 input
scaling and a ``skip_linear`` variant exposing the 512-d features.

The public input is NHWC ``[B, 84, 84, 4]`` uint8, as in the JAX package.
Inside, the input is permuted to NCHW, which is a view.  The view of a
sampled stack is not dense and the weights are contiguous OIHW, so cuDNN
transposes around each convolution (PERF.md, section 5, bottleneck 2).
Parameters are float32; compute is in ``dtype`` (bf16 by default, as in
JAX), with each weight cast at use; the Q output is float32.  The flatten
before ``fc0`` is in NCHW order (``c·49 + h·7 + w``);
:mod:`border_tpu_torch.convert` permutes the JAX ``Dense_0`` rows (NHWC
order) to match.

Under the port's GSPMDTrainer a layer's weight may be column-sharded: it
then holds the rank's block of output features and carries ``tp_group``,
the name of its model group.  :func:`linear` and :func:`conv2d` compute
that block, gather the blocks over the group and add the whole
(replicated) bias; the gradient of their input is summed over the group,
since every block reads it.  On an unsharded weight they are ``F.linear``
and ``F.conv2d``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from border_tpu_torch.utils import collectives


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   gen: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, rescaled so the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


def _tp_group(weight: torch.Tensor):
    name = getattr(weight, "tp_group", None)
    return None if name is None else collectives.group_by_name(name)


def linear(m: nn.Module, x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, w, b)`` for the layer ``m`` (``w``, ``b``: its weight
    and bias, cast for use)."""
    group = _tp_group(m.weight)
    if group is None:
        return F.linear(x, w, b)
    x = collectives.sum_grad(x, group)
    return collectives.gather_columns(F.linear(x, w), -1, group) + b


def conv2d(m: nn.Module, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int) -> torch.Tensor:
    """``F.conv2d(x, w, b, stride)`` for the layer ``m``, NCHW."""
    group = _tp_group(m.weight)
    if group is None:
        return F.conv2d(x, w, b, stride=stride)
    x = collectives.sum_grad(x, group)
    y = collectives.gather_columns(F.conv2d(x, w, stride=stride), 1, group)
    return y + b[:, None, None]


class AtariCNN(nn.Module):
    def __init__(
        self,
        out_dim: int,
        skip_linear: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        scale_in_kernel: bool = True,
        in_channels: int = 4,
    ):
        super().__init__()
        self.out_dim = out_dim
        self.skip_linear = skip_linear  # expose conv features only (IQN ψ)
        self.dtype = dtype
        # fold the /255 into conv1's weight: conv(x/255, W) + b =
        # conv(x, W/255) + b saves an elementwise pass over the input
        # (allclose, not bitwise; parameters are the same in either mode)
        self.scale_in_kernel = scale_in_kernel
        self.conv0 = nn.Conv2d(in_channels, 32, 8, stride=4)
        self.conv1 = nn.Conv2d(32, 64, 4, stride=2)
        self.conv2 = nn.Conv2d(64, 64, 3, stride=1)
        self.fc0 = nn.Linear(7 * 7 * 64, 512)
        self.fc1 = None if skip_linear else nn.Linear(512, out_dim)

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        """flax's initialisation: lecun-normal weights, zero biases."""
        with torch.no_grad():
            for m in (self.conv0, self.conv1, self.conv2, self.fc0, self.fc1):
                if m is None:
                    continue
                fan_in = m.weight[0].numel()
                _lecun_normal_(m.weight, fan_in, gen)
                m.bias.zero_()

    def _w(self, m: nn.Module, scale: float = 1.0):
        w = m.weight / scale if scale != 1.0 else m.weight
        return w.to(self.dtype), m.bias.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[B, 84, 84, 4]`` (uint8 frames, 0..255)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NCHW view
        if self.scale_in_kernel:
            w, b = self._w(self.conv0, 255.0)  # raw 0..255; /255 in conv0
        else:
            x = x / 255.0
            w, b = self._w(self.conv0)
        x = F.relu(conv2d(self.conv0, x, w, b, stride=4))
        x = F.relu(conv2d(self.conv1, x, *self._w(self.conv1), stride=2))
        x = F.relu(conv2d(self.conv2, x, *self._w(self.conv2), stride=1))
        x = x.flatten(1)  # NCHW order: c·49 + h·7 + w
        x = F.relu(linear(self.fc0, x, *self._w(self.fc0)))
        if self.skip_linear:
            return x.float()
        return linear(self.fc1, x, *self._w(self.fc1)).float()
