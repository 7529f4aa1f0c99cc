"""mfu.train: the train step's products (3 x ``flops_per_frame``) at the
window's frame rate, as a share of 495 TFLOP/s (TF32, float32 products)."""
from harness.readers import mfu


def read(ctx):
    return mfu(ctx, "train", 3)
