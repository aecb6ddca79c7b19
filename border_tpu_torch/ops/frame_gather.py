"""Frame-window gather for frame-dedup replay (≙ border_tpu/ops/frame_gather.py).

``gather_frames(frames [M, H, W], idx [B, S] int32) -> [B, S, H, W]`` with
``out[b, s] = frames[idx[b, s]]``: whole frames, any dtype.  It is the sample
op of :class:`border_tpu_torch.replay.FrameReplayBuffer`: one launch per
sampled batch in union and slice mode (``S = stack + 1``), two in separate
mode and with ``n_step > 1`` (``S = stack``).

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/frame_gather.cu`` (built with ``nvcc`` at first use, bound with
``ctypes``) on the current stream, or raises.  On a CPU tensor it runs the
plain version :func:`gather_frames_ref`.  ``gather_frames.launches`` counts
the kernel launches.  A call on a stream that a CUDA graph is capturing
launches nothing: it records the launch into the graph and counts it in
``gather_frames.captured``; every replay of that graph launches it, and the
graph's replay (:mod:`border_tpu_torch.train.graphs`) adds its captured
launches to ``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from border_tpu_torch.ops import _build


def gather_frames_ref(frames: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``frames[idx]``."""
    return frames[idx.long()]


def _lib() -> ctypes.CDLL:
    lib = _build.load("frame_gather")
    if not lib.border_gather_frames.argtypes:
        # without argtypes ctypes passes every Python int as a 32-bit int
        # and cuts the pointers
        lib.border_gather_frames.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        lib.border_gather_frames.restype = ctypes.c_int
        lib.border_cuda_error_string.argtypes = [ctypes.c_int]
        lib.border_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(frames: torch.Tensor, idx: torch.Tensor) -> None:
    if frames.dim() != 3:
        raise ValueError(f"frames must be [M, H, W], got {tuple(frames.shape)}")
    if idx.dim() != 2:
        raise ValueError(f"idx must be [B, S], got {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if frames.device != idx.device:
        raise ValueError(
            f"frames on {frames.device} but idx on {idx.device}"
        )


def gather_frames(frames: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``frames[M, H, W]``, ``idx[B, S]`` int32 → ``[B, S, H, W]``."""
    _check(frames, idx)
    if frames.device.type == "cpu":
        return gather_frames_ref(frames, idx)
    if frames.device.type != "cuda":
        raise ValueError(f"no frame-gather kernel for {frames.device}")
    if not (frames.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_frames needs contiguous frames and idx")
    m, h, w = frames.shape
    b, s = idx.shape
    out = torch.empty((b, s, h, w), dtype=frames.dtype, device=frames.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(frames.device):
        err = lib.border_gather_frames(
            frames.data_ptr(), idx.data_ptr(), out.data_ptr(),
            m, h * w * frames.element_size(), b * s,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "frame-gather kernel launch failed: "
            + lib.border_cuda_error_string(err).decode()
        )
    if torch.cuda.is_current_stream_capturing():
        gather_frames.captured += 1
    else:
        gather_frames.launches += 1
    return out


gather_frames.launches = 0
gather_frames.captured = 0
