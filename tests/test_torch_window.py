"""The port's terminal window and frame recorder against the JAX package's
(``tests/test_window.py``'s cases, then byte equality): for the same frames
the ANSI text, the PNG files and the GIF are the JAX module's, byte for
byte, and a tensor (any device) renders as its numpy array does."""

import io

import numpy as np
import pytest
import torch

from border_tpu.utils import FrameRecorder as JFrameRecorder
from border_tpu.utils import TerminalWindow as JTerminalWindow
from border_tpu_torch.utils import FrameRecorder, TerminalWindow


def _frames():
    rng = np.random.RandomState(0)
    # large frames force LZW table resets; constants hit the short-code path
    frames = [rng.randint(0, 256, (210, 160), np.uint8) for _ in range(3)]
    return frames + [np.full((210, 160), 128, np.uint8)]


def test_terminal_window_renders_ansi_halfblocks():
    buf = io.StringIO()
    win = TerminalWindow(fps=1e9, max_width=32, out=buf)
    frame = np.tile(np.arange(64, dtype=np.uint8) * 4, (64, 1))
    win.show(frame)
    out = buf.getvalue()
    assert "▀" in out
    assert "\x1b[38;5;" in out  # fg gray ramp
    # stacked obs input: newest channel is rendered
    win.show(np.stack([frame, 255 - frame], axis=-1))
    assert buf.getvalue().count("▀") > out.count("▀")


def test_terminal_window_throttles():
    buf = io.StringIO()
    win = TerminalWindow(fps=1e-9, out=buf)  # ~never redraws after first
    f = np.zeros((8, 8), np.uint8)
    win.show(f)
    first = buf.getvalue()
    win.show(f)
    assert buf.getvalue() == first


@pytest.mark.parametrize("shape, max_width", [
    ((64, 64), 32), ((84, 84, 4), 96), ((3, 84, 84, 4), 40), ((7, 9), 96)])
def test_terminal_window_text_equals_jax(shape, max_width):
    rng = np.random.RandomState(1)
    frames = [rng.randint(0, 256, shape, np.uint8) for _ in range(2)]
    out = {}
    for cls in (TerminalWindow, JTerminalWindow):
        buf = io.StringIO()
        win = cls(fps=1e9, max_width=max_width, out=buf)
        for f in frames:  # the second redraws in place (cursor up)
            win.show(f)
        out[cls] = buf.getvalue()
    assert out[TerminalWindow] == out[JTerminalWindow]
    buf = io.StringIO()
    win = TerminalWindow(fps=1e9, max_width=max_width, out=buf)
    for f in frames:
        win.show(torch.from_numpy(f))
    assert buf.getvalue() == out[JTerminalWindow]


def test_frame_recorder_pngs(tmp_path):
    rec = FrameRecorder(out_dir=str(tmp_path), every=2)
    for i in range(6):
        rec.add(np.full((16, 16), i * 40, np.uint8))
    assert len(rec) == 3
    pngs = sorted(tmp_path.glob("frame_*.png"))
    assert len(pngs) == 3
    assert pngs[0].read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_frame_recorder_png_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    obs = [rng.randint(0, 256, (84, 84, 4), np.uint8) for _ in range(5)]
    for cls, sub, conv in ((FrameRecorder, "port", torch.from_numpy),
                           (JFrameRecorder, "jax", lambda x: x)):
        rec = cls(out_dir=str(tmp_path / sub), every=2)
        for o in obs:
            rec.add(conv(o))
    port = sorted((tmp_path / "port").iterdir())
    jax_ = sorted((tmp_path / "jax").iterdir())
    assert [p.name for p in port] == [p.name for p in jax_] == [
        "frame_000000.png", "frame_000002.png", "frame_000004.png"]
    for a, b in zip(port, jax_):
        assert a.read_bytes() == b.read_bytes()


def test_gif_roundtrip(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    frames = _frames()
    rec = FrameRecorder()
    for f in frames:
        rec.add(f)
    path = rec.save_gif(str(tmp_path / "out.gif"), fps=30)
    im = PIL.open(path)
    assert im.n_frames == len(frames)
    for i, f in enumerate(frames):
        im.seek(i)
        assert np.array_equal(np.asarray(im.convert("L")), f)


@pytest.mark.parametrize("fps", [30.0, 12.5])
def test_gif_bytes_equal_jax(tmp_path, fps):
    frames = _frames()
    paths = []
    for cls, conv in ((FrameRecorder, torch.from_numpy),
                      (JFrameRecorder, lambda x: x)):
        rec = cls()
        for f in frames:
            rec.add(conv(f))
        paths.append(rec.save_gif(str(tmp_path / f"{cls.__module__}.gif"),
                                  fps=fps))
    port, jax_ = (open(p, "rb").read() for p in paths)
    assert port == jax_ and port.startswith(b"GIF89a")


def test_empty_recorder_refuses_to_write_a_gif(tmp_path):
    with pytest.raises(ValueError, match="no frames"):
        FrameRecorder().save_gif(str(tmp_path / "x.gif"))
