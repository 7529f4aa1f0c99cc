"""k4b_roofline.train: K4's backward roofline share (%), the kernels
launched under autograd's ``WindowAttentionFusedBackward`` node: its
float32 products (the recompute and the six backward products) at 495
TFLOP/s or its bytes at 3.35 TB/s, the larger, over their device time.
The node records only the incoming gradient ``[nBW, N, C]``; the heads
follow from the configuration's head width, and the additive matrix is
counted as the bias alone (``[1, heads, N, N]``), never more than it
reads."""
from harness import work
from harness.readers import roofline

OP = "WindowAttentionFusedBackward"


def bound(shapes, ctx):
    if not shapes or len(shapes[0]) != 3:
        return None
    nbw, n, c = shapes[0]
    m = ctx.config["model"]
    heads = c // (m["swin_embed_dim"] // m["swin_heads"][0])
    return work.bound_s(work.window_bwd_ops(nbw, n, c, heads),
                        work.window_bwd_bytes(nbw, n, c, heads, 1))


def read(ctx):
    return roofline(ctx, OP, bound)
