"""d2h_ms.serve: median host ms of ``cli.make_forward``'s span ``serve.d2h``:
the wait for the forward to drain, the copy back (into page-locked memory on
the card) and the numpy array; over the first traced stretch (the device
alone profiled)."""
from harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "closed", "serve.d2h")
