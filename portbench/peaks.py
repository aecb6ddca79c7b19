"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit): the yardstick of the roofline and MFU metrics."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
