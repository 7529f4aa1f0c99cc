"""enqueue_ms.serve: median host ms of ``cli.make_forward``'s span
``serve.forward``: the forward's launches enqueued (the host returns
before the card has run them); over the first traced stretch (the device
alone profiled)."""
from harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "closed", "serve.forward")
