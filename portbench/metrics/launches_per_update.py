"""Kernel launches an update: the launches of traced whole chunks less
those of a traced env phase, over the chunk's updates."""


def read(ctx):
    chunk, env = ctx.get("chunk_trace"), ctx.get("env_trace")
    if not chunk or not env or not chunk["launches"]:
        return None
    per_chunk = chunk["launches"] / ctx["traced_chunks"]
    return (per_chunk - env["launches"]) / ctx["updates_per_chunk"]
