"""Neural network models (≙ border_tpu/models): the Atari CNN, the MLPs,
the stacked MLP ensemble of the actor-critic agents' critics and the
implicit quantile network."""

from border_tpu_torch.models.cnn import AtariCNN  # noqa: F401
from border_tpu_torch.models.iqn import IQNNet  # noqa: F401
from border_tpu_torch.models.mlp import (  # noqa: F401
    ACTIVATIONS,
    MLP,
    DuelingMLP,
    EnsembleMLP,
    GaussianHeadMLP,
)
