"""Device-resident replay buffers (≙ border_tpu/replay).  Ported so far:
the transition containers, the sum tree and the frame-dedup buffer (every
mode but ``with_num_envs``); the flat ``ReplayBuffer`` follows with ROADMAP
A.10."""

from border_tpu_torch.replay.buffer import (  # noqa: F401
    PerConfig,
    Transition,
    TransitionBatch,
)
from border_tpu_torch.replay.frame_buffer import (  # noqa: F401
    FrameReplayBuffer,
    FrameReplayState,
)
from border_tpu_torch.replay.sum_tree import SumTree, SumTreeState  # noqa: F401
