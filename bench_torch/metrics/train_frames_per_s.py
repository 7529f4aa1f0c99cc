"""train_frames_per_s: frames stepped over the whole window, one sync at
its end."""
from harness.readers import frames_per_s


def read(ctx):
    return frames_per_s(ctx, "train")
