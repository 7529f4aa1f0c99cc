"""Shared building blocks (PyTorch port of ``models/common.py``).

Tensors are NHWC at every public boundary, as in the JAX package; a conv
permutes to a logical NCHW view, which for an NHWC-contiguous tensor is
PyTorch's ``channels_last`` layout, so no copy is made on the way in or out.

Numerics follow the Keras layers the reference uses: LayerNorm eps 1e-3
(channels only), BatchNorm eps 1e-3 and momentum 0.99 (batch statistics
in train mode, running statistics in eval, where ``conv_norm`` folds it
into the conv before it), LeakyReLU 0.3 (the ViT stem's
0.2), exact GELU, ELU and ReLU6 (the ResNeStUNet's and the MobileUNet's),
and flax's ``nn.Dropout``.  Params stay float32; under a bfloat16 compute dtype the convs and matmuls
run in bfloat16, while norm statistics and softmaxes are taken in float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

KERAS_LN_EPS = 1e-3
KERAS_BN_EPS = 1e-3
KERAS_BN_MOMENTUM = 0.99
LEAKY_ALPHA = 0.3


def full_f32_matmuls() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card, as
    the reference computes them: PyTorch's default lets cuDNN run f32 convs
    in TF32 (about three decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def leaky(x: torch.Tensor, slope: float = LEAKY_ALPHA) -> torch.Tensor:
    """LeakyReLU(``slope``; Keras' 0.3 by default) with flax's derivative
    at 0: ``jax.nn.leaky_relu`` is ``where(x >= 0, x, a * x)``, slope 1 at
    0, where ``F.leaky_relu`` takes slope ``a``.  Exact zeros are common
    here (the frames are zero outside the brain, and fresh biases are
    zero).  Both give the same values; without a gradient to take, the
    single fused ``F.leaky_relu`` kernel runs instead of the three of
    ``where``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.where(x >= 0, x, x * slope)
    return F.leaky_relu(x, slope)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def elu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.elu`` (alpha 1); both take slope 1 at 0."""
    return F.elu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``min(relu(x), 6)``, the MobileNetV2 blocks' activation."""
    return F.relu6(x)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """Keras ``AveragePooling2D(2, 2)``, VALID padding, NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics; returns x's
    dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight, bias, eps)
    return y.to(x.dtype)


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


def softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in float32 (float64 for float64 logits,
    as the tests' float64 runs need)."""
    return torch.softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], dilation: int = 1,
              groups: int = 1) -> torch.Tensor:
    """Stride-1 SAME conv on NHWC ``x`` with an OIHW ``weight`` (odd k:
    flax's SAME pads ``d*(k-1)/2`` on each side).  Runs in x's dtype."""
    k = weight.shape[-1]
    pad = dilation * (k - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 _cast(bias, x.dtype), padding=pad, dilation=dilation,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def flax_same_pads(size: int, kernel: int, stride: int,
                   dilation: int = 1) -> Tuple[int, int]:
    """flax/XLA ``padding='SAME'`` along one axis: the output has
    ``ceil(size / stride)`` positions and the ``total`` padding splits as
    ``(total // 2, total - total // 2)`` — asymmetric whenever ``total`` is
    odd, as for a 3x3 stride-2 conv on an even size (0 low, 1 high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC: ``padding='SAME'`` (Keras' 'same'),
    ``'VALID'`` or explicit ``((top, bottom), (left, right))`` (the
    MobileUNet's ZeroPadding2D(1) + VALID stride-2 convs, which pad (1, 1)
    where SAME pads (0, 1)), any kernel (int or (kh, kw)), stride,
    dilation and ``groups`` (flax's ``feature_group_count``: the depthwise
    convs), with or without a bias.  The stride-1 odd-kernel SAME conv
    pads symmetrically (``conv_nhwc``); any other SAME conv pads as flax
    does (``flax_same_pads``)."""

    OUT_AXIS = 0   # of the OIHW weight

    def __init__(self, cin: int, cout: int, kernel=3, dilation: int = 1,
                 stride=1, padding="SAME", groups: int = 1,
                 use_bias: bool = True):
        super().__init__()
        if padding not in ("SAME", "VALID") and (
                len(padding) != 2 or any(len(p) != 2 for p in padding)):
            raise ValueError(f"padding {padding!r} not 'SAME', 'VALID' or "
                             f"((top, bottom), (left, right))")
        self.dilation = dilation
        self.stride = _pair(stride)
        self.padding = padding
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups,
                                               *_pair(kernel)))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x):
        return self.run(x, self.weight, self.bias)

    def run(self, x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
        """This conv's geometry with ``weight`` and ``bias`` in place of its
        own (``conv_norm``'s folded ones), cast to x's dtype."""
        kh, kw = weight.shape[-2:]
        if (self.stride == (1, 1) and self.padding == "SAME"
                and kh == kw and kh % 2):
            return conv_nhwc(x, weight, bias, self.dilation, self.groups)
        y = x.permute(0, 3, 1, 2)
        if self.padding == "SAME":
            (sh, sw), d = self.stride, self.dilation
            ph = flax_same_pads(y.shape[2], kh, sh, d)
            pw = flax_same_pads(y.shape[3], kw, sw, d)
            y = F.pad(y, (*pw, *ph))
        elif self.padding != "VALID":
            ph, pw = self.padding
            y = F.pad(y, (*pw, *ph))
        y = F.conv2d(y, weight.to(x.dtype), _cast(bias, x.dtype),
                     stride=self.stride, dilation=self.dilation,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(padding='SAME')``: out = in * stride, with or
    without a bias.

    flax applies its (unflipped) kernel as a fractionally strided conv; the
    bridge stores it spatially flipped as ``[in, out, kh, kw]``, so torch's
    ``conv_transpose2d`` computes the same sums.  For k=3, s=2 no symmetric
    ``padding``/``output_padding`` reproduces flax's SAME: pad 0 gives
    ``2n+1`` rows and flax's output is the first ``2n`` (exact); for k=4,
    s=2 it is ``padding=1`` (flax pads the dilated input by 2 on each
    side), ``2n`` rows at even and odd ``n``."""

    OUT_AXIS = 1   # of the [in, out, kh, kw] weight

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 2,
                 use_bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x):
        return self.run(x, self.weight, self.bias)

    def run(self, x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
        """As ``Conv.run``: ``weight`` and ``bias`` in place of its own."""
        b, h, w, _ = x.shape
        s = self.stride
        pad = (weight.shape[-1] - s) // 2
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                               _cast(bias, x.dtype), stride=s, padding=pad)
        return y[:, :, :h * s, :w * s].permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, float32 statistics, output in the
    input's dtype."""

    def forward(self, x):
        return layer_norm_f32(x, self.weight, self.bias, self.eps)


class BatchNorm(nn.Module):
    """Keras BatchNorm over the last axis, eps 1e-3, as flax 0.12's
    ``nn.BatchNorm(momentum=0.99)`` computes it.

    Eval (``module.eval()``) normalizes with the running statistics.  Train
    takes batch statistics over every other axis in float32 (float64 for
    a float64 input, as flax promotes), the variance as
    ``max(E[x^2] - E[x]^2, 0)`` (flax's ``use_fast_variance``), normalizes
    with that biased variance and updates the running statistics in place
    as ``0.99 * running + 0.01 * batch`` — with the biased variance, where
    ``F.batch_norm`` would use the unbiased one."""

    def __init__(self, c: int, eps: float = KERAS_BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            a = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = xf * a + (self.bias - self.running_mean * a)
            return y.to(x.dtype)
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(axes)
        var = torch.clamp(xf.square().mean(axes) - mean.square(), min=0.0)
        with torch.no_grad():
            m = KERAS_BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class Norm(nn.Module):
    """Keras-flavoured norm selected by kind ('layer' | 'batch').  The inner
    module keeps flax's name (``LayerNorm_0`` / ``BatchNorm_0``) so the
    weight bridge maps names one to one."""

    def __init__(self, kind: str, c: int):
        super().__init__()
        if kind == "layer":
            self.LayerNorm_0 = LayerNorm(c, eps=KERAS_LN_EPS)
            self.inner = "LayerNorm_0"
        elif kind == "batch":
            self.BatchNorm_0 = BatchNorm(c)
            self.inner = "BatchNorm_0"
        else:
            raise ValueError(f"unknown norm {kind!r}")

    def forward(self, x):
        return getattr(self, self.inner)(x)


# conv -> BatchNorm pairs that ``conv_norm`` ran as one folded conv (eval)
# and as the conv, then the norm (train)
FOLDS = {"conv_norm": 0, "separate": 0}


def reset_fold_counts() -> None:
    for k in FOLDS:
        FOLDS[k] = 0


def conv_norm(conv: Conv | ConvTranspose, norm: Norm,
              x: torch.Tensor) -> torch.Tensor:
    """``norm(conv(x))`` for a ``Conv`` or ``ConvTranspose`` feeding ``norm``
    directly.

    An eval ``BatchNorm`` is a fixed per-channel affine map, ``y * a + (beta
    - mean * a)`` with ``a = gamma * rsqrt(var + eps)``; composed with the
    conv it is the same conv with weight ``W * a`` (per output channel) and
    bias ``(b - mean) * a + beta``, so the pair runs as that one conv and
    the norm's full-size passes over the conv's output are not made.  The
    fold is computed from the parameters and running statistics on every
    call (a few small ops), so weights substituted by ``functional_call``,
    restored or stepped are never seen stale.  A train-mode BatchNorm
    (batch statistics, the running-statistic update) and a LayerNorm run
    after the conv as they are."""
    if norm.inner != "BatchNorm_0":
        return norm(conv(x))
    bn = norm.BatchNorm_0
    if bn.training:
        FOLDS["separate"] += 1
        return norm(conv(x))
    FOLDS["conv_norm"] += 1
    a = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    shape = [1] * conv.weight.dim()
    shape[conv.OUT_AXIS] = -1
    shift = -bn.running_mean if conv.bias is None else conv.bias - bn.running_mean
    return conv.run(x, conv.weight * a.reshape(shape),
                    torch.addcmul(bn.bias, shift, a))


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode ``where(keep, x / (1 -
    rate), 0)`` with ``keep ~ Bernoulli(1 - rate)`` per element; the
    identity in eval mode.  ``keep`` is ``mask`` when one is set (a bool
    tensor of x's shape: the tests and ``chip_smoke.py`` give both
    frameworks the same masks, as JAX's threefry and torch's Philox draw
    different streams), else drawn from ``generator``, which
    ``train.step.TrainState`` sets on every dropout layer
    (``set_dropout_generator``).  Without either it refuses to draw."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.mask: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = self.mask
        if keep is None:
            if self.generator is None:
                raise RuntimeError("Dropout draws from an explicit "
                                   "torch.Generator: set_dropout_generator")
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def set_dropout_generator(model: nn.Module,
                          gen: Optional[torch.Generator]) -> None:
    """Every ``Dropout`` of ``model`` draws from ``gen``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen


def set_dropout_masks(model: nn.Module, masks) -> None:
    """``masks``: ``{module name: bool keep mask or None}`` for ``Dropout``
    layers of ``model`` (``named_modules`` names); a layer whose mask is
    None draws from its generator again."""
    mods = dict(model.named_modules())
    for name, keep in masks.items():
        if not isinstance(mods[name], Dropout):
            raise KeyError(f"{name!r} is not a Dropout layer")
        mods[name].mask = keep
