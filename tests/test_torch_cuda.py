"""Tests that need the card: the port's CUDA kernels against their plain
PyTorch versions, bitwise.  They skip without a CUDA device.

This file imports no JAX, so on a machine without it (the GPU machine) it
runs without the repo's JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from border_tpu_torch.ops import frame_gather
from border_tpu_torch.ops import gather_frames, gather_frames_ref


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, b, s, dtype",
    [
        ((37, 84, 84), 9, 4, torch.uint8),
        ((16, 12, 20), 7, 5, torch.uint8),
        ((16, 12, 20), 7, 5, torch.float32),
        ((1031, 84, 84), 513, 5, torch.uint8),  # B·S not a multiple of the block
        ((16, 7, 9), 7, 5, torch.uint8),  # 63 B frames: the byte path
    ],
)
@pytest.mark.parametrize("offset", [0, 1])  # 1: a base not 16-aligned
def test_gather_frames_kernel_matches_plain_version_on_card(shape, b, s, dtype,
                                                             offset):
    """The CUDA kernel against ``frames[idx]`` on the card, bitwise."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    m, h, w = shape
    flat = (torch.randint(0, 256, (offset + m * h * w,), generator=g,
                          device="cuda").to(dtype))
    frames = flat[offset:].view(shape)
    idx = torch.randint(0, shape[0], (b, s), generator=g, device="cuda",
                        dtype=torch.int32)
    launches = frame_gather.gather_frames.launches
    out = gather_frames(frames, idx)
    torch.cuda.synchronize()
    assert frame_gather.gather_frames.launches == launches + 1
    assert torch.equal(out, gather_frames_ref(frames, idx))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frame_buffer_sample_through_kernel_matches_cpu_path():
    """The same pushes and draws into a CUDA buffer (kernel gather) and a
    CPU buffer (plain gather): the batches are equal bitwise."""
    import types

    from border_tpu_torch.replay import FrameReplayBuffer

    dev = _cuda()
    n, cap = 8, 32
    bufs = {d: FrameReplayBuffer(cap, n, device=d) for d in ("cpu", dev)}
    states = {d: b.init() for d, b in bufs.items()}
    g = torch.Generator().manual_seed(0)
    ep = torch.zeros(n, dtype=torch.int32)
    for _ in range(cap + 5):
        obs = torch.randint(0, 256, (n, 84, 84, 4), generator=g, dtype=torch.uint8)
        act = torch.randint(0, 6, (n,), generator=g, dtype=torch.int32)
        term = torch.rand(n, generator=g) < 0.2
        for d, b in bufs.items():
            ts = types.SimpleNamespace(reward=torch.ones(n, device=d),
                                       terminated=term.to(d),
                                       truncated=torch.zeros(n, dtype=torch.bool,
                                                             device=d))
            states[d] = b.process_step(states[d], obs.to(d), act.to(d), ts,
                                       ep.to(d))
        ep = torch.where(term, 0, ep + 1).to(torch.int32)
    e, s = bufs["cpu"].draw(states["cpu"], g, 256)
    launches = frame_gather.gather_frames.launches
    got = bufs[dev].sample_at(states[dev], e.to(dev), s.to(dev))
    torch.cuda.synchronize()
    assert frame_gather.gather_frames.launches == launches + 1
    want = bufs["cpu"].sample_at(states["cpu"], e, s)
    for name in ("obs", "next_obs", "act", "terminated", "ix_sample"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_gather_frames_raises_on_non_contiguous_cuda_input():
    dev = _cuda()
    frames = torch.zeros((8, 84, 84), dtype=torch.uint8, device=dev)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        gather_frames(frames.transpose(1, 2), idx)
