"""device_idle.train: 1 - (union of the device's kernel, copy and fill
intervals) / traced window (%)."""
from harness.readers import idle_share


def read(ctx):
    return idle_share(ctx, "train")
