"""h2d_ms.serve: median host ms of ``cli.make_forward``'s span ``serve.h2d``:
the frames made contiguous and, on the card, copied chunk by chunk (16 MiB)
into the closure's reused page-locked buffer with each chunk's DMA queued
behind its host copy, the last DMA left in flight; over the first traced
stretch (the device alone profiled)."""
from harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "closed", "serve.h2d")
