"""Device-resident replay buffers (≙ border_tpu/replay).  Ported so far:
the transition containers and the frame-dedup buffer's main-path modes."""

from border_tpu_torch.replay.buffer import Transition, TransitionBatch  # noqa: F401
from border_tpu_torch.replay.frame_buffer import (  # noqa: F401
    FrameReplayBuffer,
    FrameReplayState,
)
