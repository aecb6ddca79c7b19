"""Device milliseconds an update (sample, forward, backward, optimizer,
target step), CUDA events around a chunk's update phase while the card
waits behind a sleep."""


def read(ctx):
    return ctx.get("events", {}).get("update_ms")
