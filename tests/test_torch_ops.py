"""Port's frame-gather op vs the JAX Pallas kernel.

The same frames and indices, made with numpy from a seed, go through
``border_tpu.ops.gather_frames(..., interpret=True)`` and the port's
``gather_frames`` on CPU tensors (its plain version).  A gather copies
bytes, so the tolerance is zero: the outputs must be equal bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.ops import gather_frames as jax_gather_frames
from border_tpu_torch.ops import frame_gather
from border_tpu_torch.ops import gather_frames


def _inputs(shape, dtype, b=9, s=4, seed=0):
    rng = np.random.default_rng(seed)
    m = shape[0]
    if dtype == np.uint8:
        frames = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        frames = rng.standard_normal(shape).astype(dtype)
    idx = rng.integers(0, m, (b, s), dtype=np.int32)
    return frames, idx


@pytest.mark.parametrize("shape", [(37, 84, 84), (16, 12, 20)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_gather_frames_matches_pallas_kernel(shape, dtype):
    frames, idx = _inputs(shape, dtype)
    want = np.asarray(
        jax_gather_frames(jnp.asarray(frames), jnp.asarray(idx), interpret=True)
    )
    launches = frame_gather.gather_frames.launches
    got = gather_frames(torch.from_numpy(frames), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(frames).dtype
    assert tuple(got.shape) == want.shape == (9, 4, *shape[1:])
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU path is the plain version: no kernel launch is counted
    assert frame_gather.gather_frames.launches == launches


@pytest.mark.parametrize(
    "frames_shape, idx_shape, idx_dtype, err",
    [
        ((4, 8, 8), (2, 3), torch.int64, TypeError),  # idx must be int32
        ((4, 64), (2, 3), torch.int32, ValueError),  # frames must be 3-D
        ((4, 8, 8), (6,), torch.int32, ValueError),  # idx must be 2-D
    ],
)
def test_gather_frames_rejects_what_the_kernel_does_not_take(
    frames_shape, idx_shape, idx_dtype, err
):
    frames = torch.zeros(frames_shape, dtype=torch.uint8)
    idx = torch.zeros(idx_shape, dtype=idx_dtype)
    with pytest.raises(err):
        gather_frames(frames, idx)
