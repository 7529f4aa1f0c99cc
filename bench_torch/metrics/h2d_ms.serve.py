"""h2d_ms.serve: median host ms of ``cli.make_forward``'s span ``serve.h2d``:
the frames made contiguous, wrapped and copied from pageable memory to the
card; over the first traced stretch (the device alone profiled)."""
from harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "closed", "serve.h2d")
