"""Live display for pixel envs — terminal renderer + PNG/GIF capture
(≙ border_tpu/utils/window.py).

≙ border-atari-env's winit/pixels display window
(border-atari-env/src/env/window.rs:1-67).  Headless GPU hosts have no
display server, so the equivalent surface here is:

- :class:`TerminalWindow` — renders grayscale frames into the terminal with
  ANSI half-block characters (2 pixels per character cell, 256-color
  grayscale), throttled to a target fps; works over ssh/tmux.
- :class:`FrameRecorder` — captures frames to PNGs (the stdlib zlib encoder
  shared with the TFEvent writer) or an animated GIF, for offline viewing.

Both accept the env's observation stacks ([H, W, stack] uint8, newest frame
last — the layout of border_tpu_torch.envs.pixel) or raw [H, W] frames, as
numpy arrays or as tensors on any device.
"""

from __future__ import annotations

import os
import struct
import sys
import time
from typing import List, Optional

import numpy as np

from border_tpu_torch.record.tfevent import encode_png_gray


def _to_frame(obs) -> np.ndarray:
    """[H,W] | [H,W,stack] | [N,H,W,stack] → one [H,W] uint8 frame."""
    if hasattr(obs, "detach"):  # a tensor, on any device
        obs = obs.detach().cpu().numpy()
    f = np.asarray(obs)
    if f.ndim == 4:
        f = f[0]
    if f.ndim == 3:
        f = f[..., -1]  # newest frame in the stack
    return f.astype(np.uint8)


class TerminalWindow:
    """ANSI half-block live view (2 vertical pixels per character row)."""

    def __init__(self, fps: float = 30.0, max_width: int = 96,
                 out=None):
        self.min_dt = 1.0 / fps
        self.max_width = max_width
        self.out = out or sys.stdout
        self._last = 0.0
        self._lines = 0

    def show(self, obs) -> None:
        now = time.monotonic()
        if now - self._last < self.min_dt:
            return
        self._last = now
        frame = _to_frame(obs)
        h, w = frame.shape
        step = max(1, (w + self.max_width - 1) // self.max_width)
        frame = frame[::step, ::step]
        if frame.shape[0] % 2:
            frame = frame[:-1]
        top, bot = frame[0::2], frame[1::2]
        # 24-step grayscale ramp of the 256-color cube (232..255)
        t = 232 + (top.astype(np.int32) * 24) // 256
        b = 232 + (bot.astype(np.int32) * 24) // 256
        rows = []
        for tr_, br_ in zip(t, b):
            cells = [
                f"\x1b[38;5;{a};48;5;{c}m▀" for a, c in zip(tr_, br_)
            ]
            rows.append("".join(cells) + "\x1b[0m")
        if self._lines:
            self.out.write(f"\x1b[{self._lines}A")  # cursor up: redraw in place
        self.out.write("\n".join(rows) + "\n")
        self.out.flush()
        self._lines = len(rows)

    def close(self) -> None:
        self._lines = 0


class FrameRecorder:
    """Capture frames; write PNGs per frame and/or one animated GIF."""

    def __init__(self, out_dir: Optional[str] = None, every: int = 1):
        self.out_dir = out_dir
        self.every = every
        self._frames: List[np.ndarray] = []
        self._i = 0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def add(self, obs) -> None:
        self._i += 1
        if (self._i - 1) % self.every:
            return
        frame = _to_frame(obs)
        self._frames.append(frame)
        if self.out_dir:
            with open(os.path.join(
                self.out_dir, f"frame_{self._i - 1:06d}.png"
            ), "wb") as f:
                f.write(encode_png_gray(frame))

    def __len__(self) -> int:
        return len(self._frames)

    def save_gif(self, path: str, fps: float = 30.0) -> str:
        """Minimal GIF89a writer: grayscale palette, one full frame per
        image, LZW-encoded (stdlib only)."""
        if not self._frames:
            raise ValueError("no frames captured")
        h, w = self._frames[0].shape
        delay = max(2, int(round(100.0 / fps)))
        out = bytearray()
        out += b"GIF89a"
        out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)  # GCT: 256 entries
        for i in range(256):
            out += bytes((i, i, i))
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
        for frame in self._frames:
            out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00"
            out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
            out += _gif_lzw(frame.reshape(-1))
        out += b"\x3b"
        with open(path, "wb") as f:
            f.write(bytes(out))
        return path


def _gif_lzw(data: np.ndarray) -> bytes:
    """LZW compression for one GIF image (8-bit codes)."""
    min_code = 8
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    table = {bytes((i,)): i for i in range(1 << min_code)}
    next_code = eoi + 1
    code_size = min_code + 1

    bits = bytearray()
    acc = 0
    nbits = 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            bits.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear, code_size)
    prefix = b""
    for v in data.tolist():
        nxt = prefix + bytes((v,))
        if nxt in table:
            prefix = nxt
            continue
        emit(table[prefix], code_size)
        table[nxt] = next_code
        next_code += 1
        if next_code > (1 << code_size) and code_size < 12:
            code_size += 1
        elif next_code >= 4096:
            emit(clear, code_size)
            table = {bytes((i,)): i for i in range(1 << min_code)}
            next_code = eoi + 1
            code_size = min_code + 1
        prefix = bytes((v,))
    if prefix:
        emit(table[prefix], code_size)
    emit(eoi, code_size)
    if nbits:
        bits.append(acc & 0xFF)

    body = bytes((min_code,))
    for i in range(0, len(bits), 255):
        chunk = bits[i : i + 255]
        body += bytes((len(chunk),)) + bytes(chunk)
    return body + b"\x00"
