"""Neural network models (≙ border_tpu/models).  Ported so far: the Atari
CNN."""

from border_tpu_torch.models.cnn import AtariCNN  # noqa: F401
