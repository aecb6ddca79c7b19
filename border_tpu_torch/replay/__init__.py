"""Device-resident replay buffers (≙ border_tpu/replay): the flat ring
buffer, the transition containers, the sum tree and the frame-dedup buffer
(every mode but ``with_num_envs``)."""

from border_tpu_torch.replay.buffer import (  # noqa: F401
    PerConfig,
    ReplayBuffer,
    ReplayBufferState,
    Transition,
    TransitionBatch,
    map_obs,
)
from border_tpu_torch.replay.frame_buffer import (  # noqa: F401
    FrameReplayBuffer,
    FrameReplayState,
)
from border_tpu_torch.replay.sum_tree import SumTree, SumTreeState  # noqa: F401
