"""Device milliseconds a vector env step (act, step, push), CUDA events
around a chunk's env phase while the card waits behind a sleep."""


def read(ctx):
    return ctx.get("events", {}).get("env_step_ms")
