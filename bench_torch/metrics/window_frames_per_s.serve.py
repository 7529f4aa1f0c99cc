"""window_frames_per_s.serve: frames answered over the whole window on the
host's clock, back-to-back batches through ``cli.make_forward``'s
callable, its copies included (the frames staged through reused
page-locked memory, the answer read back into page-locked memory)."""
from harness.readers import frames_per_s


def read(ctx):
    return frames_per_s(ctx, "closed")
