"""Dependency-free TensorBoard event-file writer
(own copy of border_tpu/record/tfevent.py; the port imports nothing of the
JAX package).

≙ border-tensorboard (border-tensorboard/src/lib.rs:17-126), which wraps a
126-LoC Rust TFRecord writer — here the same scope (scalars, 2-D arrays as
images, other arrays as histograms) is implemented directly on the TFRecord
wire format with only the standard library:

- TFRecord framing: ``u64 length | u32 masked-crc32c(length) | payload |
  u32 masked-crc32c(payload)``,
- hand-encoded ``tf.Event``/``Summary`` protobufs (varint + tag wire
  format; the few message fields used are stable since TF 1.x),
- grayscale PNG encoding for image summaries via :mod:`zlib`.

Only the standard library and numpy are imported: no ``torch`` SummaryWriter,
no tensorflow.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (software, table-driven) + TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reflected
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _pb_string(field: int, s: str) -> bytes:
    return _pb_bytes(field, s.encode("utf-8"))


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_packed_doubles(field: int, vs: Sequence[float]) -> bytes:
    return _pb_bytes(field, b"".join(struct.pack("<d", float(v)) for v in vs))


# ---------------------------------------------------------------------------
# PNG (grayscale, 8-bit) for image summaries
# ---------------------------------------------------------------------------


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + kind
        + payload
        + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF)
    )


def encode_png_gray(img: np.ndarray) -> bytes:
    """2-D uint8 array → grayscale PNG bytes."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(raw))
        + _png_chunk(b"IEND", b"")
    )


# ---------------------------------------------------------------------------
# summary/event encoders
# ---------------------------------------------------------------------------


def _scalar_value(tag: str, value: float) -> bytes:
    return _pb_bytes(1, _pb_string(1, tag) + _pb_float(2, float(value)))


def _image_value(tag: str, arr: np.ndarray) -> bytes:
    a = np.asarray(arr, np.float32)
    lo, hi = float(a.min()), float(a.max())
    scaled = (a - lo) / (hi - lo) * 255.0 if hi > lo else np.zeros_like(a)
    png = encode_png_gray(scaled.astype(np.uint8))
    image = (
        _pb_int(1, arr.shape[0])  # height
        + _pb_int(2, arr.shape[1])  # width
        + _pb_int(3, 1)  # colorspace: grayscale
        + _pb_bytes(4, png)
    )
    return _pb_bytes(1, _pb_string(1, tag) + _pb_bytes(4, image))


def _histogram_value(tag: str, arr: np.ndarray, bins: int = 30) -> bytes:
    a = np.asarray(arr, np.float64).ravel()
    counts, edges = np.histogram(a, bins=bins)
    histo = (
        _pb_double(1, float(a.min()))
        + _pb_double(2, float(a.max()))
        + _pb_double(3, float(a.size))
        + _pb_double(4, float(a.sum()))
        + _pb_double(5, float(np.square(a).sum()))
        + _pb_packed_doubles(6, edges[1:])
        + _pb_packed_doubles(7, counts)
    )
    return _pb_bytes(1, _pb_string(1, tag) + _pb_bytes(5, histo))


def _event(step: int, summary_values: bytes = b"", file_version: str = "") -> bytes:
    ev = _pb_double(1, time.time()) + _pb_int(2, int(step))
    if file_version:
        ev += _pb_string(3, file_version)
    if summary_values:
        ev += _pb_bytes(5, summary_values)  # Summary { repeated Value value=1 }
    return ev


class TFEventWriter:
    """Append-only TensorBoard events file (stdlib only)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{time.time():.6f}.{socket.gethostname()}"
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._record(_event(0, file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(step, _scalar_value(tag, value)))

    def add_image(self, tag: str, arr: np.ndarray, step: int) -> None:
        """2-D array rendered as a min/max-normalized grayscale image
        (≙ the Array2-as-image behavior, border-tensorboard lib.rs:56-99)."""
        self._record(_event(step, _image_value(tag, arr)))

    def add_histogram(self, tag: str, arr: np.ndarray, step: int) -> None:
        self._record(_event(step, _histogram_value(tag, arr)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
