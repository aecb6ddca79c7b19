"""Device resolution shared by the port's entry points.

Entry points (``Trainer``, ``VecEnv``, the replay buffers, ``DQN.init``,
``IQN.init``) take ``device=None``, which means the GPU.  Without one they raise instead of
falling back to the CPU: a caller that wants the CPU (the tests do) says so.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return dev


def as_generator(seed_or_gen, device: torch.device,
                 into: Optional[torch.Generator] = None) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: an ``int`` seeds a new one, or
    re-seeds ``into`` in place (a generator a CUDA graph holds keeps its
    place); a generator is passed through (it must live on ``device``)."""
    if isinstance(seed_or_gen, torch.Generator):
        if seed_or_gen.device.type != torch.device(device).type:
            raise ValueError(
                f"generator on {seed_or_gen.device}, expected {device}"
            )
        return seed_or_gen
    gen = torch.Generator(device=device) if into is None else into
    return gen.manual_seed(int(seed_or_gen))
