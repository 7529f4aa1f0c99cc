"""forward_device_ms.serve: device ms a call of the kernels launched under
``cli.make_forward``'s span ``serve.forward`` (the range
``port::serve.forward``), the mean over the host-traced stretch."""
from harness.spans import device_ms

OP = "port::serve.forward"


def read(ctx):
    return device_ms(ctx, "closed", OP)
