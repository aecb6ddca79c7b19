"""MLP models (≙ border_tpu/models/mlp.py).

flax's ``Dense`` infers its input width when the model is initialised; the
modules here take ``in_dim`` (``obs_space.flat_dim``).  ``dtype`` is the
compute type: parameters stay float32 and are cast at use, the output is
float32.  ``reset_parameters`` draws flax's default initialisation:
lecun-normal weights and zero biases.

:class:`EnsembleMLP` holds n MLPs of one shape as stacked parameters and
computes them all in one batched matmul a layer, the counterpart of
``jax.vmap`` over stacked flax params (the actor-critic agents' critics).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from border_tpu_torch.models.cnn import _lecun_normal_, _tp_group, linear
from border_tpu_torch.utils import collectives

ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's default
    "none": lambda x: x,
}


def dense(m: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``m`` applied in ``dtype`` (the float32 parameters cast at use)."""
    return linear(m, x, m.weight.to(dtype), m.bias.to(dtype))


def reset_linears(linears, gen: Optional[torch.Generator]) -> None:
    """flax's ``Dense`` initialisation, layer by layer in the given order."""
    with torch.no_grad():
        for m in linears:
            _lecun_normal_(m.weight, m.in_features, gen)
            m.bias.zero_()


class _Trunk(nn.Module):
    """``hidden`` Dense+activation layers; subclasses add their heads."""

    def __init__(self, in_dim: int, hidden: Sequence[int], activation: str,
                 dtype: torch.dtype):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.dtype = dtype
        widths = [in_dim, *hidden]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.trunk_dim = widths[-1]

    def heads(self) -> Tuple[nn.Linear, ...]:
        raise NotImplementedError

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        reset_linears([*self.layers, *self.heads()], gen)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for m in self.layers:
            x = self.act(dense(m, x, self.dtype))
        return x


class MLP(_Trunk):
    """ReLU MLP: obs (or obs‖act) → out_dim."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden: Sequence[int] = (64, 64), activation: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_dim, hidden, activation, dtype)
        self.out = nn.Linear(self.trunk_dim, out_dim)

    def heads(self):
        return (self.out,)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.out, self.trunk(x), self.dtype).float()


class DuelingMLP(_Trunk):
    """Dueling Q-head (Wang et al. 2016): shared trunk → V(s) + A(s,a),
    Q = V + A − mean(A); enabled via ``DQNConfig(dueling=True)``."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden: Sequence[int] = (64, 64), activation: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_dim, hidden, activation, dtype)
        self.value = nn.Linear(self.trunk_dim, 1)
        self.advantage = nn.Linear(self.trunk_dim, out_dim)

    def heads(self):
        return (self.value, self.advantage)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.trunk(x)
        v = dense(self.value, x, self.dtype)
        a = dense(self.advantage, x, self.dtype)
        return (v + a - a.mean(dim=-1, keepdim=True)).float()


class GaussianHeadMLP(_Trunk):
    """Two-headed (mean, log_std) MLP for stochastic actors; ``log_std`` is
    clamped to ``[log_std_min, log_std_max]``."""

    def __init__(self, in_dim: int, act_dim: int,
                 hidden: Sequence[int] = (64, 64), activation: str = "relu",
                 log_std_min: float = -20.0, log_std_max: float = 2.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_dim, hidden, activation, dtype)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        self.mean = nn.Linear(self.trunk_dim, act_dim)
        self.log_std = nn.Linear(self.trunk_dim, act_dim)

    def heads(self):
        return (self.mean, self.log_std)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.trunk(x)
        mean = dense(self.mean, x, self.dtype).float()
        log_std = dense(self.log_std, x, self.dtype).float()
        return mean, log_std.clamp(self.log_std_min, self.log_std_max)


class EnsembleMLP(nn.Module):
    """``n`` MLPs of the same widths: layer i holds ``weights[i]`` of shape
    ``[n, in, out]`` (flax's kernel layout, a leading member axis) and
    ``biases[i]`` of ``[n, out]``, and is one ``torch.baddbmm``.  Maps
    ``[B, in_dim]``, the same input for every member, to
    ``[n, B, out_dim]``; float32."""

    def __init__(self, n: int, in_dim: int, out_dim: int,
                 hidden: Sequence[int] = (64, 64), activation: str = "relu"):
        super().__init__()
        self.n = n
        self.act = ACTIVATIONS[activation]
        widths = [in_dim, *hidden, out_dim]
        self.weights = nn.ParameterList(
            nn.Parameter(torch.empty(n, a, b))
            for a, b in zip(widths[:-1], widths[1:]))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(n, b)) for b in widths[1:])

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        """flax's ``Dense`` initialisation for every member."""
        with torch.no_grad():
            for w, b in zip(self.weights, self.biases):
                _lecun_normal_(w, w.shape[1], gen)
                b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.expand(self.n, *x.shape)
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            group = _tp_group(w)  # a column-sharded [n, in, out/tp] block
            if group is None:
                x = torch.baddbmm(b[:, None, :], x, w)
            else:
                x = collectives.sum_grad(x, group)
                x = collectives.gather_columns(torch.bmm(x, w), -1, group) \
                    + b[:, None, :]
            if i < last:
                x = self.act(x)
        return x
