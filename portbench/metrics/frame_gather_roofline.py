"""The frame gather's share of its roofline, %: the least time its bytes
take at the HBM peak over its mean time in the trace's kernel rows.  The
bytes are the work of a sample whatever implements it: ``B·S`` frames
read once and written once, and ``B·S`` int32 indices, with ``S`` the
union window (stack + 1)."""

from portbench import peaks

KERNEL = "gather_frames_kernel"


def gather_bytes(batch: int, window: int, frame_bytes: int) -> int:
    return 2 * batch * window * frame_bytes + 4 * batch * window


def read(ctx):
    rows = [v for k, v in ctx.get("chunk_trace", {}).get("rows", {}).items()
            if KERNEL in k]
    count = sum(c for c, _ in rows)
    if not count:
        return None
    mean_s = sum(s for _, s in rows) / count
    cfg = ctx["cfg"]
    h, w = cfg["torso"]["frame"]
    least = gather_bytes(cfg["agent"]["batch_size"], cfg["torso"]["stack"] + 1,
                         h * w) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / mean_s
