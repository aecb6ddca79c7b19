"""Observation/action space descriptions (≙ border_tpu/core/spaces.py).

Static metadata objects; ``zero()`` mints a torch tensor (a dict of them
for :class:`Dict`) used to size buffers and networks before the first step,
and ``sample(gen)`` one random element, drawn from an explicit
``torch.Generator`` on the generator's device (the JAX spaces take a key).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict as DictT, Tuple

import numpy as np
import torch


class Space:
    shape: Tuple[int, ...]
    dtype: Any

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def zero(self, device=None) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=device)

    def contains(self, x) -> bool:
        raise NotImplementedError

    @property
    def flat_dim(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclasses.dataclass(frozen=True)
class Discrete(Space):
    """{0, 1, ..., n-1} with int32 representation."""

    n: int
    dtype: Any = torch.int32

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        """Uniform over ``{0, …, n−1}``."""
        return torch.randint(0, self.n, (), generator=gen, dtype=self.dtype,
                             device=gen.device)

    def contains(self, x) -> bool:
        x = torch.as_tensor(x)
        return bool(((x >= 0) & (x < self.n)).all())

    @property
    def flat_dim(self) -> int:
        return self.n


@dataclasses.dataclass(frozen=True)
class Box(Space):
    """Bounded (possibly unbounded) box."""

    low: Any
    high: Any
    shape: Tuple[int, ...] = ()
    dtype: Any = torch.float32

    def __post_init__(self):
        if not self.shape:
            s = np.shape(self.low) or np.shape(self.high)
            object.__setattr__(self, "shape", tuple(s))

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        """Uniform over the box where both bounds are finite, standard
        normal where either is not (as the JAX space)."""
        dev = gen.device
        low = torch.as_tensor(self.low, dtype=self.dtype).to(dev).expand(self.shape)
        high = torch.as_tensor(self.high, dtype=self.dtype).to(dev).expand(self.shape)
        finite = torch.isfinite(low) & torch.isfinite(high)
        u = torch.rand(self.shape, generator=gen, dtype=self.dtype, device=dev)
        z = torch.randn(self.shape, generator=gen, dtype=self.dtype, device=dev)
        bounded = low + u * torch.where(finite, high - low, 2.0)
        return torch.where(finite, bounded, z)

    def contains(self, x) -> bool:
        x = torch.as_tensor(x).double()
        return bool(
            tuple(x.shape) == tuple(self.shape)
            and (x >= float(np.min(self.low)) - 1e-6).all()
            and (x <= float(np.max(self.high)) + 1e-6).all()
        )


@dataclasses.dataclass(frozen=True)
class Dict(Space):
    """Dict-structured space (goal-reaching dict observations).  The
    entries are stored sorted by key, as ``(key, space)`` pairs, so the
    default key order of a flattened observation is the sorted one."""

    spaces: Any  # a mapping name -> Space; stored as sorted (k, v) pairs

    def __post_init__(self):
        if isinstance(self.spaces, dict):
            object.__setattr__(self, "spaces", tuple(sorted(self.spaces.items())))

    def as_dict(self) -> DictT[str, Space]:
        return dict(self.spaces)

    @property
    def shape(self):  # type: ignore[override]
        return {k: v.shape for k, v in self.spaces}

    @property
    def dtype(self):  # type: ignore[override]
        return {k: v.dtype for k, v in self.spaces}

    def sample(self, gen: torch.Generator):
        """One sample of each entry, in the sorted key order."""
        return {k: s.sample(gen) for k, s in self.spaces}

    def zero(self, device=None):
        return {k: s.zero(device) for k, s in self.spaces}

    def contains(self, x) -> bool:
        d = dict(self.spaces)
        return isinstance(x, dict) and set(x) == set(d) and all(
            d[k].contains(v) for k, v in x.items())

    @property
    def flat_dim(self) -> int:
        return sum(s.flat_dim for _, s in self.spaces)
