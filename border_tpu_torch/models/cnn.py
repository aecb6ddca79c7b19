"""DQN-paper CNN for pixel observations (≙ border_tpu/models/cnn.py).

conv 32×8s4 → 64×4s2 → 64×3s1 → fc(3136→512) → out, with /255 input
scaling and a ``skip_linear`` variant exposing the 512-d features.

The public input is NHWC ``[B, 84, 84, C]`` uint8, as in the JAX package;
parameters are float32 in the JAX-convertible order (OIHW convolutions,
``fc0``'s columns in NCHW flatten order ``c·49 + h·7 + w``, to which
:mod:`border_tpu_torch.convert` permutes the JAX ``Dense_0`` rows).  Compute
is in ``dtype`` (bf16 by default, as in JAX); the Q output is float32.

The layout handed to the convolutions is channels-last throughout, so cuDNN
runs its NHWC tensor-core kernels and inserts no transposes:

- conv0 (8×8, stride 4) runs as the 2×2, stride-1 convolution over the
  space-to-depth input ``[B, 16·C, 21, 21]`` (:func:`space_to_depth`: input
  channel ``c·16 + p·4 + q`` holds pixel ``(4i + p, 4j + q)`` of frame
  ``c``), which sums the same products.  Its 16·C channels (64 for 4
  frames, 16 for one) are a multiple of 8, as cuDNN's bf16 tensor-core
  kernels want; C channels alone send it to a float32 engine.  (At batch
  192–256 the H100's cuDNN still has only a TF32 engine for this shape,
  fed by exact bf16 → float32 copies: PERF.md, section 6.)  The
  rearrangement is the cast's one copy of the uint8 frames.
- Every weight is cast at use, and that one copy also lays it out: conv0's
  as ``[32, 16·C, 2, 2]``, conv1's and conv2's channels-last, and ``fc0``'s
  columns permuted to the NHWC flatten order ``h·448 + w·64 + c`` of
  conv2's channels-last output, which is then flattened as a view.
  Gradients reach the float32 masters through these copies.

Under the port's GSPMDTrainer a layer's weight may be column-sharded: it
then holds the rank's block of output features and carries ``tp_group``,
the name of its model group.  :func:`linear` and :func:`conv2d` compute
that block, gather the blocks over the group and add the whole
(replicated) bias; the gradient of their input is summed over the group,
since every block reads it.  On an unsharded weight they are ``F.linear``
and ``F.conv2d``.  The at-use layouts keep the output features first, so
they apply to a block as to the whole weight.
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


def space_to_depth(x: torch.Tensor, block: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """NHWC ``x`` ``[B, H, W, C]`` (any strides) → ``[B, block²·C, H/block,
    W/block]`` in ``dtype``, channels-last, in one copy: channel
    ``(c·block + p)·block + q`` at ``(i, j)`` is ``x[:, block·i + p,
    block·j + q, c]``.  In the copy's order a frame's ``block`` neighbouring
    pixels of a row are read together.

    One call a torso forward, counted as :func:`border_tpu_torch.ops.
    gather_frames` counts its launches: ``launches`` the forwards run
    (eagerly, or by the replays of a graph that recorded them:
    :mod:`border_tpu_torch.train.graphs`), ``captured`` those recorded into
    a capturing CUDA graph."""
    b, h, w, c = x.shape
    x = x.unflatten(1, (h // block, block)).unflatten(3, (w // block, block))
    x = x.permute(0, 1, 3, 5, 2, 4)  # [B, i, j, C, p, q]
    x = x.to(dtype, memory_format=torch.contiguous_format)
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        space_to_depth.captured += 1
    else:
        space_to_depth.launches += 1
    return x.reshape(b, h // block, w // block, -1).permute(0, 3, 1, 2)


space_to_depth.launches = 0
space_to_depth.captured = 0


def space_to_depth_weight(w: torch.Tensor, block: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """OIHW ``w`` ``[O, C, K, K]`` of a stride-``block`` convolution →
    ``[O, block²·C, K/block, K/block]`` in ``dtype``, channels-last, in one
    copy: the weight of the stride-1 convolution over
    :func:`space_to_depth`'s input that sums the same products."""
    o, _, kh, kw = w.shape
    w = w.unflatten(2, (kh // block, block)).unflatten(4, (kw // block, block))
    w = w.permute(0, 2, 4, 1, 3, 5)  # [O, a, b, C, p, q]
    w = w.to(dtype, memory_format=torch.contiguous_format)
    return w.reshape(o, kh // block, kw // block, -1).permute(0, 3, 1, 2)


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

    def _w(self, m: nn.Module, memory_format=torch.preserve_format):
        return (m.weight.to(self.dtype, memory_format=memory_format),
                m.bias.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[B, 84, 84, C]`` (uint8 frames, 0..255)."""
        block = self.conv0.stride[0]
        x = space_to_depth(x, block, self.dtype)
        w0 = self.conv0.weight
        if self.scale_in_kernel:
            w0 = w0 / 255.0  # raw 0..255; /255 in conv0
        else:
            x = x / 255.0
        w0 = space_to_depth_weight(w0, block, self.dtype)
        x = F.relu(conv2d(self.conv0, x, w0, self.conv0.bias.to(self.dtype),
                          stride=1))
        cl = torch.channels_last
        x = F.relu(conv2d(self.conv1, x, *self._w(self.conv1, cl), stride=2))
        x = F.relu(conv2d(self.conv2, x, *self._w(self.conv2, cl), stride=1))
        shape = x.shape[1:]
        x = x.permute(0, 2, 3, 1).flatten(1)  # NHWC order: h·448 + w·64 + c
        # fc0's columns from NCHW order to x's, in the cast's copy
        w = self.fc0.weight.unflatten(1, shape).permute(0, 2, 3, 1)
        w = w.to(self.dtype, memory_format=torch.contiguous_format).flatten(1)
        x = F.relu(linear(self.fc0, x, w, self.fc0.bias.to(self.dtype)))
        if self.skip_linear:
            return x.float()
        return linear(self.fc1, x, *self._w(self.fc1)).float()
