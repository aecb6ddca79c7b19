"""Device milliseconds a vector env step inside the window: the span
``chunk.env`` of each window chunk (CUDA events the program records at the
env phase's edges, on its stream) over the chunk's vector env steps; the
median over the window's chunks (``portbench/chunks.py``)."""

from portbench.chunks import per, window_median


def read(ctx):
    return window_median(lambda r: per(r["device_ms"].get("chunk.env"), r["vec_steps"]))
