"""device_frames_per_s: frames over the card's busy time (the union of its
kernel, copy and fill intervals) in a 2 s stretch of the cell's own
traffic traced on the device alone, after the window: the rate at which
the card runs the cell's work, whatever the host's speed.  The window's
rate on the host's clock, which the host's speed moves, is the per-layer
``window_frames_per_s.*``."""
from harness.readers import device_frames_per_s


def read(ctx):
    return device_frames_per_s(ctx)
