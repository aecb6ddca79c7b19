"""Hand-written Hopper kernels for the framework's hot memory ops
(≙ border_tpu/ops).

The gather and the sum tree have a plain PyTorch version beside the kernel
in their module: the wrapper runs it for CPU tensors (the tests), and
``chip_smoke.py`` holds the kernel against it on the card.  The Adam
kernel's plain version is torch's own capturable Adam: ``make_optimizer``
builds torch's Adam on the CPU, and ``adam_step`` takes CUDA tensors only.
"""

from border_tpu_torch.models.cnn import space_to_depth
from border_tpu_torch.ops.adam import adam_step
from border_tpu_torch.ops.frame_gather import gather_frames, gather_frames_ref
from border_tpu_torch.ops.sum_tree import (
    sum_tree_sample,
    sum_tree_sample_ref,
    sum_tree_update,
    sum_tree_update_ref,
)

# the wrappers that count their kernel's launches (``launches``) and the
# launches they record into a capturing CUDA graph (``captured``); beside
# the kernels', the torso's forwards in the space-to-depth layout
COUNTED = (gather_frames, space_to_depth, sum_tree_update, sum_tree_sample,
           adam_step)

__all__ = ["COUNTED", "adam_step", "gather_frames",
           "gather_frames_ref", "sum_tree_sample", "sum_tree_sample_ref",
           "sum_tree_update", "sum_tree_update_ref"]
