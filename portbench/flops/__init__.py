"""Model FLOPs of a chunk, one module per configuration
(``flops/<config>.py``), each with ``chunk_flops(cfg, updates_per_chunk)``.

Counted from the configuration's shapes, a multiply-add as two FLOPs:
the acting forward of every env step, and for each update the forwards
and backwards the algorithm needs once each; nothing a program computes
twice is counted twice.  A backward is twice its forward, less the input
gradient that no parameter needs (the first layer's, and the cosine
embedding's).  Elementwise work is not counted.
"""
