"""Device milliseconds an update inside the window: the span
``chunk.update`` of each window chunk (CUDA events the program records at
the update phase's edges) over the chunk's updates; the median over the
window's chunks (``portbench/chunks.py``)."""

from portbench.chunks import per, window_median


def read(ctx):
    return window_median(lambda r: per(r["device_ms"].get("chunk.update"), r["updates"]))
