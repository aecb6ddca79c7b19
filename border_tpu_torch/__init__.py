"""border_tpu_torch — the PyTorch + CUDA port of :mod:`border_tpu` for
NVIDIA Hopper.

Same sub-package layout and names as the JAX package, so each module's
counterpart is found under the same path:

- :mod:`border_tpu_torch.core`   — spaces, batched Env/VecEnv, Agent contract.
- :mod:`border_tpu_torch.envs`   — batched on-device games (Pong, Breakout,
  Seaquest, Freeway, Space Invaders) under the DQN pixel wrapper, the
  classic-control family and the dict-observation Reacher; the host-env
  path's envs (the C++ env pool, Gymnasium-API envs, the real-ALE seam).
- :mod:`border_tpu_torch.replay` — frame-dedup replay (uniform or
  prioritized; union, separate and slice sampling; n-step), every frame
  read through the frame-gather kernel; the flat ring buffer (uniform,
  prioritized, n-step, dict observations); the device sum tree.
- :mod:`border_tpu_torch.ops`    — hand-written CUDA kernels (``csrc/``),
  built with ``nvcc`` at first use, and the build of the C++ host envs.
- :mod:`border_tpu_torch.models` — the Atari CNN, the MLPs and the critic
  ensemble, the implicit quantile network.
- :mod:`border_tpu_torch.agents` — DQN, IQN, SAC, and the offline family
  BC, AWAC and IQL.
- :mod:`border_tpu_torch.data`   — offline corpora, the Minari dataset
  layer, normalized-score evaluation.
- :mod:`border_tpu_torch.train`  — TrainerConfig, the chunked Trainer
  (evaluation, model saves, checkpoints, resume), the AsyncTrainer, the
  host-env trainer and evaluator, the OfflineTrainer, the Evaluator, and
  ``run_elastic`` (restart from the latest checkpoint after a crash).
- :mod:`border_tpu_torch.parallel` — multi-GPU training on
  ``torch.distributed``, one process per GPU: the sharded trainers
  (synchronous and decoupled), the dp×tp GSPMD trainer, meshes and process
  groups.
- :mod:`border_tpu_torch.record` — Record/Recorder telemetry, TensorBoard
  event files, MLflow tracking.
- :mod:`border_tpu_torch.utils`  — device resolution, the full-state
  CheckpointManager, the build cache, profiling, policy export to numpy,
  agents and envs from YAML, terminal display and GIF capture.
- :mod:`border_tpu_torch.convert` — carries weights and state over from numpy
  arrays taken from the JAX package, and loads a JAX-saved agent.
- :mod:`border_tpu_torch.examples` — the runnable entry points,
  ``python -m border_tpu_torch.examples.<name>``.

It imports ``torch`` and numpy, never ``jax`` or ``border_tpu``.  Entry
points (trainers, evaluators, envs, replay buffers, every agent's ``init``,
the checkpoint manager, the converters, ``init_distributed``, the
examples) run on the GPU unless the caller passes ``device="cpu"`` (the
examples: ``--device cpu``).
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
