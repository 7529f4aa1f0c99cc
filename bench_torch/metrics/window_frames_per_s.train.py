"""window_frames_per_s.train: frames stepped over the whole window on the
host's clock, one sync at its end."""
from harness.readers import frames_per_s


def read(ctx):
    return frames_per_s(ctx, "train")
