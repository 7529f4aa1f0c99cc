"""Swin transformer backbone and segmentation head, train and eval (PyTorch
port of ``models/swin.py``).

A 4x4 stride-4 VALID patch conv embeds the ``[B, H, W, C]`` frames (its
bias drawn non-zero, see ``SwinBackbone``), then stages of ``SwinBlock``
(pre-LN window attention with a learned relative-position bias, every odd
block shifted by ``min(window) // 2`` with the -100 mask, an exact-GELU
MLP, stochastic depth on both residual branches) joined by
``PatchMerging``; the decoder upsamples the last stage through the
per-stage features with transposed convs and ends in a float32 softmax.
Odd sizes are padded bottom/right before a window partition or a merge;
a stage no larger than the window attends over one ``(m, m)`` window,
``m = min(H, W)``, unshifted.

The module tree keeps flax's names (``backbone``, ``proj``,
``patch_norm``, ``layer{i}_block{d}``, ``norm1``, ``attn``, ``mlp_fc1``,
``layer{i}_downsample``, ``reduction``, ``up_{i}``, ``fuse_{i}``,
``up_final1``, ``head``) for the weight bridge (family ``'swin'``); the
attention's raw ``qkv_kernel`` / ``proj_kernel`` are the ``qkv`` /
``proj`` linears here.

The compute dtype is passed down the forward, and every layer casts its
input to it as flax's ``dtype=`` does; the residual stream keeps whatever
dtype its sums promote to.  ``attn_impl`` picks the attention:

* ``'kernel'`` — K4 (``ops.kernels.window_attention_fused``: the CUDA
  forward, the recompute backward with its attention part in one CUDA
  kernel), the JAX ``'pallas'`` route; where no gradient is taken
  (serving, the exported program) its forward op alone.  Its output is in
  its input's dtype, so under bfloat16 the residual stream stays bfloat16;
* ``'composed'`` — ``ops.window_attn.window_attention`` then the
  projection, the JAX ``'xla'`` route.  The float32 params promote its
  output to float32, so under bfloat16 the residual stream is float32.

``DropPath`` draws from an explicit ``torch.Generator``
(``set_drop_path_generator``; the Trainer's is ``TrainState.drop_gen``).

Left out: loading ImageNet-pretrained weights (``utils/swin_convert.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrasound_modeling_tpu_torch.models.common import (
    Conv, ConvTranspose, LayerNorm, gelu)
from ultrasound_modeling_tpu_torch.models.transunet import (
    Segmenter, _linear, check_impls)
from ultrasound_modeling_tpu_torch.ops import kernels
from ultrasound_modeling_tpu_torch.ops import window_attn as wa

SWIN_LN_EPS = 1e-5
PATCH = (4, 4)


def _pad_hw(x: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Pad ``[B, H, W, C]`` bottom/right so H % mh == 0 and W % mw == 0."""
    ph, pw = (-x.shape[1]) % mh, (-x.shape[2]) % mw
    return F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x


def _norm(norm: LayerNorm, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=cdt)``: float32 statistics, output in cdt."""
    return norm(x).to(cdt)


class DropPath(nn.Module):
    """Stochastic depth: in train mode at ``rate > 0``, ``x / keep *
    floor(keep + u)`` with ``u`` uniform in [0, 1) per batch element, drawn
    in x's dtype from ``generator``."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if self.generator is None:
            raise RuntimeError("DropPath draws from an explicit "
                               "torch.Generator: set_drop_path_generator")
        # keep in x's dtype, as JAX takes a Python scalar beside an array
        keep = float(torch.tensor(1.0 - self.rate, dtype=x.dtype))
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = torch.rand(shape, generator=self.generator, dtype=x.dtype,
                       device=x.device)
        return x / keep * torch.floor(keep + u)


def set_drop_path_generator(model: nn.Module,
                            gen: Optional[torch.Generator]) -> None:
    """Every ``DropPath`` of ``model`` draws from ``gen``."""
    for m in model.modules():
        if isinstance(m, DropPath):
            m.generator = gen


class WindowAttention(nn.Module):
    """Window MSA with a relative-position bias; ``qkv`` / ``proj`` hold
    flax's raw ``qkv_kernel [C, 3C]`` / ``proj_kernel [C, C]`` in
    ``Linear`` layout."""

    def __init__(self, dim: int, window: Tuple[int, int], num_heads: int,
                 attn_impl: str):
        super().__init__()
        wh, ww = window
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("rel_index", torch.from_numpy(
            wa.relative_position_index(window)), persistent=False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        table = self.relative_position_bias_table
        if self.attn_impl == "composed":
            ctx = wa.window_attention(x.float(), self.qkv.weight, self.qkv.bias,
                                      table, self.rel_index, self.num_heads,
                                      mask)
            return F.linear(ctx, self.proj.weight, self.proj.bias)
        return kernels.window_attention_fused(
            x, self.qkv.weight, self.qkv.bias, self.proj.weight,
            self.proj.bias, self.num_heads, bias_table=table,
            rel_index=self.rel_index, mask=mask)


class SwinBlock(nn.Module):
    """W-MSA / SW-MSA block on tokens ``[B, H*W, C]``."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window: Tuple[int, int] = (4, 5),
                 shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, attn_impl: str = "kernel"):
        super().__init__()
        h, w = input_resolution
        if min(h, w) <= min(window):       # degenerate window
            m = min(h, w)
            window, shift = (m, m), 0
        self.resolution, self.window, self.shift = (h, w), tuple(window), shift
        self.padded = (h + (-h) % window[0], w + (-w) % window[1])
        mask = (torch.from_numpy(wa.shifted_window_mask(*self.padded, window,
                                                         shift))
                if shift else None)
        self.register_buffer("attn_mask", mask, persistent=False)
        self.norm1 = LayerNorm(dim, eps=SWIN_LN_EPS)
        self.attn = WindowAttention(dim, window, num_heads, attn_impl)
        self.drop_path1 = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(dim, eps=SWIN_LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.drop_path2 = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
        (h, w), (hp, wp), s = self.resolution, self.padded, self.shift
        b, l, c = x.shape
        y = _pad_hw(_norm(self.norm1, x, cdt).view(b, h, w, c), *self.window)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = self.attn(wa.window_partition(y, self.window), self.attn_mask)
        y = wa.window_reverse(y, self.window, hp, wp)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        y = y[:, :h, :w, :].reshape(b, l, c)
        x = x + self.drop_path1(y)
        z = gelu(_linear(_norm(self.norm2, x, cdt), self.mlp_fc1))
        return x + self.drop_path2(_linear(z, self.mlp_fc2))


class PatchMerging(nn.Module):
    """2x2 space-to-channel (odd sizes padded), LayerNorm, a bias-free
    linear reduction to ``2 * dim``."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int]):
        super().__init__()
        self.resolution = input_resolution
        self.norm = LayerNorm(4 * dim, eps=SWIN_LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
        b, _, c = x.shape
        x = _pad_hw(x.view(b, *self.resolution, c), 2, 2)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = _norm(self.norm, x.reshape(b, -1, 4 * c), cdt)
        return F.linear(x, self.reduction.weight.to(cdt))


def merged_resolution(res: Tuple[int, int]) -> Tuple[int, int]:
    return ((res[0] + 1) // 2, (res[1] + 1) // 2)


class SwinBackbone(nn.Module):
    """Patch embed, then stages of SwinBlocks; returns the final-LN output
    ``[B, h, w, C_last]`` and the features before each merge."""

    def __init__(self, img_size: Tuple[int, int] = (256, 80),
                 in_channels: int = 10, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: Tuple[int, int] = (4, 5), mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, patch_norm: bool = True,
                 attn_impl: str = "kernel"):
        super().__init__()
        self.embed_dim, self.depths = embed_dim, tuple(depths)
        # The patch conv's bias is drawn non-zero (flax normal(0.02) at
        # init; random_flax_variables draws every bias): the frames are
        # exactly zero outside the brain, and a zero bias would embed those
        # patches to constant rows whose LayerNorm backward amplifies by
        # 1/sqrt(eps) per norm (models/swin.py:221-231 in the JAX package).
        self.proj = Conv(in_channels, embed_dim, PATCH, stride=PATCH,
                         padding="VALID")
        self.patch_norm = (LayerNorm(embed_dim, eps=SWIN_LN_EPS)
                           if patch_norm else None)
        res = (img_size[0] // PATCH[0], img_size[1] // PATCH[1])
        dpr = np.linspace(0.0, drop_path_rate, sum(self.depths))
        self.stages = []
        blk = 0
        for i, (depth, heads) in enumerate(zip(self.depths, num_heads)):
            dim = embed_dim * 2 ** i
            names = []
            for d in range(depth):
                shift = 0 if d % 2 == 0 else min(window) // 2
                self.add_module(f"layer{i}_block{d}", SwinBlock(
                    dim, res, heads, window, shift, mlp_ratio,
                    float(dpr[blk]), attn_impl))
                names.append(f"layer{i}_block{d}")
                blk += 1
            merge = None
            if i < len(self.depths) - 1:
                merge = f"layer{i}_downsample"
                self.add_module(merge, PatchMerging(dim, res))
            self.stages.append((names, merge, res, dim))
            if merge:
                res = merged_resolution(res)
        self.out_resolution = res
        self.norm = LayerNorm(embed_dim * 2 ** (len(self.depths) - 1),
                              eps=SWIN_LN_EPS)

    def forward(self, x: torch.Tensor, cdt: torch.dtype):
        b = x.shape[0]
        x = self.proj(x.to(cdt))
        x = x.reshape(b, -1, self.embed_dim)
        if self.patch_norm is not None:
            x = _norm(self.patch_norm, x, cdt)
        features = []
        for names, merge, res, dim in self.stages:
            for name in names:
                x = getattr(self, name)(x, cdt)
            if merge:
                features.append(x.reshape(b, *res, dim))
                x = getattr(self, merge)(x, cdt)
        final = _norm(self.norm, x, cdt).reshape(b, *self.out_resolution, -1)
        return final, features


class SwinSegmenter(Segmenter):
    """Input NHWC ``[B, H, W, in_channels]`` float32 -> probabilities
    ``[B, H, W, num_classes]`` float32.  Params stay float32; activations
    run in ``compute_dtype``."""

    family = "swin"   # the weight bridge's name for this tree

    def __init__(self, num_classes: int = 3,
                 img_size: Tuple[int, int] = (256, 80), in_channels: int = 10,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: Tuple[int, int] = (4, 5),
                 drop_path_rate: float = 0.1, attn_impl: str = "kernel",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_impls(attn_impl, "composed")
        self.img_size = tuple(img_size)
        self.compute_dtype = compute_dtype
        self.backbone = SwinBackbone(img_size, in_channels, embed_dim, depths,
                                     num_heads, window,
                                     drop_path_rate=drop_path_rate,
                                     attn_impl=attn_impl)
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        cin = dims[-1]
        for i, ch in enumerate(reversed(dims[:-1])):
            self.add_module(f"up_{i}", ConvTranspose(cin, ch, 3, 2))
            self.add_module(f"fuse_{i}", Conv(2 * ch, ch, 3))
            cin = ch
        mid = max(embed_dim // 2, 32)
        self.up_final1 = ConvTranspose(cin, mid, 3, 2)
        self.head = ConvTranspose(mid, num_classes, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        y, features = self.backbone(x, cdt)
        for i, skip in enumerate(reversed(features)):
            y = getattr(self, f"up_{i}")(y.to(cdt))
            y = y[:, :skip.shape[1], :skip.shape[2]]
            y = torch.cat([y, skip], dim=-1)
            y = gelu(getattr(self, f"fuse_{i}")(y.to(cdt)))
        y = gelu(self.up_final1(y))
        logits = self.head(y)[:, :self.img_size[0], :self.img_size[1]]
        return torch.softmax(logits.float(), dim=-1)
