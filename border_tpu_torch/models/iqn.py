"""Implicit Quantile Network model (≙ border_tpu/models/iqn.py).

ψ feature extractor, φ cosine embedding ``act(linear(cos(τ·π·i)))``, merge
``f(ψ ⊙ φ)``.  The τ axis is a plain tensor axis, so all K quantiles ride
one matmul.

ψ is either an MLP over the flat observation (``psi_mlp``: the hidden
layers, then the projection to ``feature_dim``) or, with ``psi_fn``, a
module built by that factory (``AtariCNN(out_dim=0, skip_linear=True)``:
512 features, bf16 inside, float32 out) followed by ``psi_proj``.  The
activation is applied again after the projection, as in the JAX model.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
from torch import nn

from border_tpu_torch.models.mlp import ACTIVATIONS, dense, reset_linears


def _linears(widths: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))


class IQNNet(nn.Module):
    """obs [B, ...] + taus [B, K] → quantile values [B, K, out_dim]."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        feature_dim: int = 64,
        n_cos: int = 64,
        psi_hidden: Sequence[int] = (64,),
        f_hidden: Sequence[int] = (64,),
        activation: str = "relu",
        dtype: torch.dtype = torch.float32,
        psi_fn: Any = None,
        psi_dim: int = 512,
    ):
        """``psi_fn``: a factory of the ψ module (no arguments); its output
        width is ``psi_dim``.  Without it ``in_dim`` sizes the ψ MLP."""
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.dtype = dtype
        self.n_cos = n_cos
        if psi_fn is not None:
            self.psi = psi_fn()
            self.psi_proj = nn.Linear(psi_dim, feature_dim)
            self.psi_mlp = None
        else:
            self.psi = self.psi_proj = None
            self.psi_mlp = _linears([in_dim, *psi_hidden, feature_dim])
        self.phi = nn.Linear(n_cos, feature_dim)
        self.f = _linears([feature_dim, *f_hidden, out_dim])

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        if self.psi is not None:
            self.psi.reset_parameters(gen)
            reset_linears([self.psi_proj], gen)
        else:
            reset_linears(self.psi_mlp, gen)
        reset_linears([self.phi, *self.f], gen)

    def forward(self, obs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
        act, dt = self.act, self.dtype
        # ψ: state features [B, F]
        if self.psi is not None:
            psi = dense(self.psi_proj, self.psi(obs).to(dt), dt)
        else:
            x = obs.to(dt)
            for m in self.psi_mlp[:-1]:
                x = act(dense(m, x, dt))
            psi = dense(self.psi_mlp[-1], x, dt)
        psi = act(psi)

        # φ: cosine embedding of τ → [B, K, F]
        i = torch.arange(1, self.n_cos + 1, dtype=torch.float32,
                         device=taus.device)
        cos = torch.cos(taus[..., None] * math.pi * i)  # [B, K, n_cos]
        phi = act(dense(self.phi, cos.to(dt), dt))

        # merge f(ψ ⊙ φ) → quantile values
        z = psi[:, None, :] * phi  # [B, K, F]
        for m in self.f[:-1]:
            z = act(dense(m, z, dt))
        return dense(self.f[-1], z, dt).float()  # [B, K, out_dim]
