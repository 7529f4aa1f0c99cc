"""k4_roofline.serve: K4's forward roofline share (%), the kernels launched
under ``ultrasound_port::window_attention``: its float32 products at 495
TFLOP/s or its bytes (x, the weights, the additive matrix, the output) at
3.35 TB/s, the larger, over their device time."""
from harness import work
from harness.readers import roofline

OP = "ultrasound_port::window_attention"


def bound(shapes, ctx):
    if len(shapes) < 7 or len(shapes[0]) != 3 or len(shapes[6]) != 4:
        return None
    nbw, n, c = shapes[0]
    n_add, heads = shapes[6][0], shapes[6][1]
    x_bytes = 2 if ctx.config["model"]["compute_dtype"] == "bfloat16" else 4
    return work.bound_s(work.window_ops(nbw, n, c, heads),
                        work.window_bytes(nbw, n, c, heads, n_add, x_bytes))


def read(ctx):
    return roofline(ctx, OP, bound)
