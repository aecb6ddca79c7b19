"""Utilities of the port."""

from border_tpu_torch.utils.device import as_generator, resolve_device  # noqa: F401
from border_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: F401
