"""Device milliseconds between two chunks of the window: from a chunk's
last phase event to the next chunk's first, the device waiting on the
counter copy, the metrics copy and the host's work between chunks; the
median over the window's chunks (``portbench/chunks.py``)."""

from portbench.chunks import window_median


def read(ctx):
    return window_median(lambda r: r["gap_ms"])
