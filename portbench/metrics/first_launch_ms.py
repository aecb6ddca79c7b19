"""Host milliseconds of the first graph replay's launch in each phase of a
window chunk, summed over the chunk's phases (``LoopGraph.run`` times it:
a launch queue that is full stalls it); the median over the window's
chunks (``portbench/chunks.py``)."""

from portbench.chunks import window_median


def read(ctx):
    return window_median(lambda r: r["first_launch_ms"])
