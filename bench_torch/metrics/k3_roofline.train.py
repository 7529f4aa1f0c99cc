"""k3_roofline.train: K3 forward's roofline share (%), the kernels launched
under the profiler's record of ``FlashMHA.apply`` (``ops.kernels.flash_mha``):
its float32 products (the scores and P.V of each sequence and head) at
495 TFLOP/s or its bytes (qkv ``[B*N, 3C]`` in, the context ``[B*N, C]``
and the row LSE ``[B, h, N]`` out, all float32) at 3.35 TB/s, the larger,
over their device time.  The record carries qkv's shape where torch
records an autograd Function's inputs; where it carries none, B is the
mix's batch.  N, C and h come from the configuration."""
from harness import work
from harness.readers import roofline

OP = "FlashMHA"


def bound(shapes, ctx):
    m = ctx.config["model"]
    n, h = m["vit_grid"][0] * m["vit_grid"][1], m["vit_heads"]
    if shapes and len(shapes[0]) == 2:
        rows, c = shapes[0][0], shapes[0][1] // 3
    else:
        rows, c = ctx.cell.traffic["batch"] * n, m["vit_hidden"]
    b = rows // n
    nbytes = (rows * (3 * c + c) + b * h * n) * 4
    return work.bound_s(work.attn(b, h, n, c // h), nbytes)


def read(ctx):
    return roofline(ctx, OP, bound)
