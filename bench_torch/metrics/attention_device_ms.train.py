"""attention_device_ms.train: device ms a call of the kernels launched under
the span ``attention.train`` (the range ``port::attention.train``) that
``models.transunet.Attention`` opens in train mode: the qkv weights'
concatenation and projection, the attention core (K3 on the ``flash``
route) and the output projection of the forward; the mean over the
host-traced stretch.  A program without
the span leaves nothing to read."""
from harness.spans import device_ms

OP = "port::attention.train"


def read(ctx):
    return device_ms(ctx, "train", OP)
