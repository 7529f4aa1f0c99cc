"""mfu.serve: the serving forward's products (``flops_per_frame``) at the
window's frame rate, as a share of the card's peak for the configuration's
type (989 TFLOP/s bf16, 495 TF32 for float32)."""
from harness.readers import mfu


def read(ctx):
    return mfu(ctx, "closed", 1)
