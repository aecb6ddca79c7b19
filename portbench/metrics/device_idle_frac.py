"""Share of the traced wall of whole chunks in which no kernel, copy or set
ran on the device.  An upper bound: the profiler's own host cost is in
the wall."""


def read(ctx):
    t = ctx.get("chunk_trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["wall_s"]
