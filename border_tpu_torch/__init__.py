"""border_tpu_torch — the PyTorch + CUDA port of :mod:`border_tpu` for
NVIDIA Hopper.

Same sub-package layout and names as the JAX package, so each module's
counterpart is found under the same path:

- :mod:`border_tpu_torch.core`   — spaces, batched Env/VecEnv, Agent contract.
- :mod:`border_tpu_torch.envs`   — batched on-device games (Pong, Breakout,
  Seaquest, Freeway, Space Invaders) under the DQN pixel wrapper, and the
  classic-control family.
- :mod:`border_tpu_torch.replay` — frame-dedup replay (uniform or
  prioritized; union, separate and slice sampling; n-step), every frame
  read through the frame-gather kernel; the flat ring buffer (uniform,
  prioritized, n-step); the device sum tree.
- :mod:`border_tpu_torch.ops`    — hand-written CUDA kernels (``csrc/``),
  built with ``nvcc`` at first use.
- :mod:`border_tpu_torch.models` — the Atari CNN, the MLPs, the implicit
  quantile network.
- :mod:`border_tpu_torch.agents` — DQN and IQN.
- :mod:`border_tpu_torch.train`  — TrainerConfig, the chunked Trainer
  (evaluation, model saves, checkpoints, resume) and the Evaluator.
- :mod:`border_tpu_torch.record` — Record/Recorder telemetry, TensorBoard
  event files.
- :mod:`border_tpu_torch.utils`  — device resolution, full-state
  CheckpointManager.
- :mod:`border_tpu_torch.convert` — carries weights and state over from numpy
  arrays taken from the JAX package.

It imports ``torch`` and numpy, never ``jax`` or ``border_tpu``.  Entry
points (``Trainer``, ``VecEnv``, ``FrameReplayBuffer``, ``ReplayBuffer``,
``DQN.init``, ``IQN.init``) run on the GPU unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from border_tpu_torch.core import spaces  # noqa: F401
from border_tpu_torch.core.env import Environment, VecEnv  # noqa: F401
from border_tpu_torch.errors import (  # noqa: F401
    BorderTpuError,
    ConfigError,
    RecordKeyError,
    RecordValueTypeError,
)
