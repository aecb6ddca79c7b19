"""The whole step's share of the card's bf16 peak, %: the model FLOPs of
the chunks the window completed (``flops/<config>.py``) over the window's
seconds."""

from portbench import peaks


def read(ctx):
    w = ctx["window"]
    return 100.0 * w["chunks"] * ctx["chunk_flops"] / w["seconds"] / peaks.BF16_FLOPS
