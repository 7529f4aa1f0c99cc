"""k1_roofline.serve: K1's roofline share (%), the kernels launched under
``ultrasound_port::transformer_block``: its products at 989 TFLOP/s (bf16)
or its bytes (x, the weights, the output) at 3.35 TB/s, the larger, over
their device time."""
from harness import work
from harness.readers import roofline

OP = "ultrasound_port::transformer_block"


def bound(shapes, ctx):
    if not shapes or len(shapes[0]) != 3:
        return None
    b, s, c = shapes[0]
    m = ctx.config["model"]
    final_ln = len(shapes) > 5 and bool(shapes[5])
    return work.bound_s(work.block_ops(b, s, c, m["num_heads"], m["mlp_dim"]),
                        work.block_bytes(b, s, c, m["mlp_dim"], final_ln))


def read(ctx):
    return roofline(ctx, OP, bound)
