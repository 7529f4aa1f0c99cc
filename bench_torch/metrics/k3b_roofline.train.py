"""k3b_roofline.train: K3 backward's roofline share (%), the kernels
launched under autograd's ``FlashMHABackward`` node: the five float32
products its kernel computes for each sequence and head (the score
recompute, dP, dQ, dV and dK) at 495 TFLOP/s or its bytes (qkv ``[B*N,
3C]``, the row LSE ``[B, h, N]`` and the context gradient ``[B*N, C]`` in,
dqkv ``[B*N, 3C]`` out, all float32) at 3.35 TB/s, the larger, over their
device time.  The node records the incoming gradient ``[B*N, C]``; where
it records none, B is the mix's batch.  N, C and h come from the
configuration."""
from harness import work
from harness.readers import roofline

OP = "FlashMHABackward"


def bound(shapes, ctx):
    m = ctx.config["model"]
    n, h = m["vit_grid"][0] * m["vit_grid"][1], m["vit_heads"]
    if shapes and len(shapes[0]) == 2:
        rows, c = shapes[0]
    else:
        rows, c = ctx.cell.traffic["batch"] * n, m["vit_hidden"]
    b = rows // n
    nbytes = (rows * (3 * c + c + 3 * c) + b * h * n) * 4
    return work.bound_s(work.attn(b, h, n, c // h, products=5), nbytes)


def read(ctx):
    return roofline(ctx, OP, bound)
