"""The arithmetic of the plain reference: every product (linear, matmul,
convolution) goes through one :class:`Numerics` object, so that the same
reference code runs in the precision a configuration states and, as the
control of a correctness check, one step below it.

* ``f32``  -- float32 products with TF32 off (the reference proper);
* ``tf32`` -- the same products with TF32 on: the control of a float32
  configuration;
* ``fp8``  -- each operand of every product rounded to float8 e4m3 (one
  scale per tensor, its largest magnitude mapped to 448) and the product
  taken in float32: the control of a bfloat16 configuration.

Norms, softmaxes and elementwise work stay in float32 in every mode.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8")
E4M3_MAX = 448.0


class Numerics:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"unknown numerics {mode!r}; expected one of "
                             f"{MODES}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the products of this mode read it."""
        if self.mode != "fp8":
            return t
        amax = t.detach().abs().amax().float()
        scale = torch.where(amax > 0, amax / E4M3_MAX, 1.0)
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.q(x), self.q(w), b, **kw)

    def conv_transpose2d(self, x, w, b=None, **kw):
        return F.conv_transpose2d(self.q(x), self.q(w), b, **kw)

    @contextlib.contextmanager
    def active(self):
        """TF32 on in ``tf32`` mode and off otherwise, for the duration;
        the flags as they were afterwards."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
