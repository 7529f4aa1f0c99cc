"""serve_frames_per_s: frames answered over the whole window, back-to-back
batches through ``cli.make_forward``'s callable (copies included)."""
from harness.readers import frames_per_s


def read(ctx):
    return frames_per_s(ctx, "closed")
