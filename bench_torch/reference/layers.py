"""Plain building blocks of the reference models: NHWC tensors, float32
parameters, every product through a :class:`~numerics.Numerics`.

The numerics follow the Keras layers of the original models (LayerNorm and
BatchNorm eps 1e-3 unless a model says otherwise, LeakyReLU 0.3, exact
GELU, flax's SAME padding).  Module and parameter names follow the
program's state dict, so one set of seeded weights loads into both.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .numerics import Numerics

LN_EPS = 1e-3
BN_EPS = 1e-3
LEAKY = 0.3


def leaky(x):
    return F.leaky_relu(x, LEAKY)


def gelu(x):
    return F.gelu(x, approximate="none")


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1):
    """flax's ``padding='SAME'`` along one axis: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC (``SAME`` or ``VALID``), OIHW weight."""

    def __init__(self, nx: Numerics, cin: int, cout: int, kernel=3,
                 dilation: int = 1, stride=1, padding: str = "SAME",
                 use_bias: bool = True):
        super().__init__()
        self.nx, self.dilation, self.stride = nx, dilation, _pair(stride)
        self.padding = padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, *_pair(kernel)))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x):
        y = x.permute(0, 3, 1, 2)
        kh, kw = self.weight.shape[-2:]
        if self.padding == "SAME":
            (sh, sw), d = self.stride, self.dilation
            ph = same_pads(y.shape[2], kh, sh, d)
            pw = same_pads(y.shape[3], kw, sw, d)
            y = F.pad(y, (*pw, *ph))
        y = self.nx.conv2d(y, self.weight, self.bias, stride=self.stride,
                           dilation=self.dilation)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(padding='SAME')``, out = in * stride; the
    weight ``[in, out, kh, kw]`` holds flax's kernel spatially flipped."""

    def __init__(self, nx: Numerics, cin: int, cout: int, kernel: int = 3,
                 stride: int = 2):
        super().__init__()
        self.nx, self.stride = nx, stride
        self.weight = nn.Parameter(torch.zeros(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        _, h, w, _ = x.shape
        s, k = self.stride, self.weight.shape[-1]
        y = self.nx.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight,
                                     self.bias, stride=s, padding=(k - s) // 2)
        return y[:, :, :h * s, :w * s].permute(0, 2, 3, 1)


class Linear(nn.Module):
    """``x @ weight.T + bias``, weight ``[out, in]``."""

    def __init__(self, nx: Numerics, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.nx = nx
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return self.nx.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last axis with the running statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        a = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return x * a + (self.bias - self.running_mean * a)


class Norm(nn.Module):
    """A LayerNorm (eps 1e-3) or BatchNorm under flax's inner name."""

    def __init__(self, kind: str, c: int):
        super().__init__()
        self.inner = {"layer": "LayerNorm_0", "batch": "BatchNorm_0"}[kind]
        self.add_module(self.inner, LayerNorm(c, LN_EPS) if kind == "layer"
                        else BatchNorm(c))

    def forward(self, x):
        return getattr(self, self.inner)(x)


def group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               gsize: int, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm of each group of ``gsize`` contiguous channels of the last
    axis; ``scale`` and ``bias`` hold one value per channel."""
    shape = y.shape
    yg = y.reshape(*shape[:-1], shape[-1] // gsize, gsize)
    mu = yg.mean(-1, keepdim=True)
    zc = yg - mu
    var = (zc * zc).mean(-1, keepdim=True)
    out = (zc * torch.rsqrt(var + eps)).reshape(shape)
    return out * scale.reshape(-1) + bias.reshape(-1)


def avg_pool2(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def softmax_last(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def l2_kernels(model: nn.Module, attention: type) -> List[nn.Parameter]:
    """The weights the original's Keras L2 rule regularizes: the kernels of
    its conv, transposed-conv and dense layers, the MLPs' ``fc1`` / ``fc2``
    among them; not the projections of an ``attention`` module (its query,
    key, value and out, or qkv and proj, are the attention's own kernels),
    not biases, norm scales or tables."""
    own = {id(m) for a in model.modules() if isinstance(a, attention)
           for m in a.children()}
    return [m.weight for m in model.modules()
            if isinstance(m, (Conv, ConvTranspose, Linear)) and id(m) not in own]


def optional_pad(x: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Pad ``[B, H, W, C]`` bottom and right to multiples of (mh, mw)."""
    ph, pw = (-x.shape[1]) % mh, (-x.shape[2]) % mw
    return F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x

