"""Step counters that a CUDA graph can advance.

An agent's ``n_opts``/``n_samples`` and a replay buffer's write position are
host ints: they advance by fixed amounts, so the CPU path's schedules, draw
ranges and write slots cost no device→host sync.  A captured CUDA graph
cannot read them (it would replay the value it saw at capture), so a state
on a CUDA device also holds them as an int64 tensor ``counts``, one entry
per name in the state class's ``COUNTERS``, and its CUDA path reads and
advances that tensor in place, eagerly and under replay alike.  The host
ints stay as mirrors for the trainer's cadences: eagerly they advance with
the tensor, and after graph replays :func:`sync_counters` sets them from it
in one device→host copy.  On the CPU ``counts`` is None and the host ints
are the counters.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from border_tpu_torch.envs.pixel import true_div

Count = Union[int, torch.Tensor]


def new_counts(device, values: Sequence[int]) -> Optional[torch.Tensor]:
    """``values`` as the int64 ``counts`` of a state on ``device``: a tensor
    on a CUDA device, None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return torch.tensor(list(values), dtype=torch.int64, device=device)


def count(state, name: str) -> Count:
    """The counter ``name`` as the state's path reads it: the host int on
    the CPU, a 0-dim view of ``counts`` on a CUDA device."""
    if state.counts is None:
        return getattr(state, name)
    return state.counts[type(state).COUNTERS.index(name)]


def advance(state, name: str, n: int) -> None:
    """``name`` += ``n``: the host int, and ``counts`` in place."""
    setattr(state, name, getattr(state, name) + n)
    if state.counts is not None:
        state.counts[type(state).COUNTERS.index(name)].add_(n)


def set_counts(state, **values: int) -> None:
    """Set host ints and their device entries (a state built from saved or
    converted values)."""
    for name, v in values.items():
        setattr(state, name, int(v))
    if state.counts is not None:
        state.counts.copy_(torch.tensor(
            [getattr(state, n) for n in type(state).COUNTERS]))


def counts_of(*states) -> Optional[torch.Tensor]:
    """The ``counts`` of ``states`` laid end to end (None where no state
    holds any): what :func:`set_mirrors` reads back on the host."""
    held = [s.counts for s in states if s is not None and s.counts is not None]
    return torch.cat(held) if held else None


def set_mirrors(states, values: Sequence[int]) -> None:
    """The host ints of ``states`` set from ``values``, a host copy of
    :func:`counts_of` the same states."""
    i = 0
    for s in states:
        if s is None or s.counts is None:
            continue
        for name in type(s).COUNTERS:
            setattr(s, name, int(values[i]))
            i += 1


def sync_counters(*states) -> None:
    """The host ints of ``states`` set from their ``counts``, one copy to
    the host for all of them (the mirrors after graph replays)."""
    held = counts_of(*states)
    if held is not None:
        set_mirrors(states, held.tolist())


def linear_f32(n: Count, n_final: int, start: float, end: float):
    """``start + clip(n / n_final, 0, 1)·(end − start)`` in float32 (the ε
    and β schedules): a Python float of a host int, a 0-dim float32 tensor
    of a device count.  The two are the same float32 operations."""
    f32 = np.float32
    if not torch.is_tensor(n):
        frac = np.clip(f32(n) / f32(n_final), f32(0), f32(1))
        return float(f32(start) + frac * (f32(end) - f32(start)))
    frac = true_div(n.float(), float(f32(n_final))).clamp(0.0, 1.0)
    return frac * float(f32(end) - f32(start)) + float(f32(start))


def randint_below(n: torch.Tensor, shape, gen: Optional[torch.Generator]
                  ) -> torch.Tensor:
    """Integers uniform over ``[0, n)`` for a device scalar ``n`` ≥ 1 (a
    draw range a graph replays): 62 random bits modulo ``n``, int64.  The
    bias is below ``n / 2^62``."""
    return torch.randint(0, 1 << 62, shape, generator=gen,
                         device=n.device) % n
