"""Plain reference of the Swin segmenter (silverlight6/Ultrasound_Modeling,
``SwinTransformer.py``), train and eval:

a 4x4 stride-4 patch conv and LayerNorm -> four stages of Swin blocks
(pre-LN window attention over (4, 5) windows with a learned
relative-position bias, every odd block shifted by 2 with the -100 mask,
an exact-GELU MLP of ratio 4, stochastic depth rising linearly to 0.1 over
the blocks) joined by patch merging (2x2 to channels, LayerNorm, a
bias-free linear to twice the width) -> a final LayerNorm -> a decoder of
3x3 stride-2 transposed convs with skip concatenation and 3x3 fuse convs
-> softmax over the classes.  A stage no larger than the window attends
over one (m, m) window, m = min(H, W), unshifted; odd sizes are padded
bottom and right.

Float32 throughout; every product goes through ``nx``.  Stochastic depth
draws one uniform number per sample from ``generator`` in the order the
blocks run, as the program does.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from .layers import (Conv, ConvTranspose, LayerNorm, Linear, gelu, l2_kernels,
                     optional_pad)
from .numerics import Numerics

LN_EPS = 1e-5
PATCH = 4


def relative_position_index(wh: int, ww: int) -> torch.Tensor:
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return torch.from_numpy(rel.sum(-1))


def shifted_mask(h: int, w: int, wh: int, ww: int, shift: int) -> torch.Tensor:
    """``[num_windows, N, N]``: -100 between tokens of different regions
    before the cyclic shift, 0 elsewhere."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -shift), slice(-shift, None)):
        for ws in (slice(0, -ww), slice(-ww, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // wh, wh, w // ww, ww).transpose(0, 2, 1, 3)
    win = win.reshape(-1, wh * ww)
    diff = win[:, None, :] - win[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0).astype(np.float32))


def partition(x, wh, ww):
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, c)


def unpartition(x, wh, ww, h, w):
    c = x.shape[-1]
    x = x.reshape(-1, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


class DropPath(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = float(torch.tensor(1.0 - self.rate, dtype=x.dtype))
        u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                       generator=self.generator, dtype=x.dtype, device=x.device)
        return x / keep * torch.floor(keep + u)


class WindowAttention(nn.Module):
    def __init__(self, nx: Numerics, dim: int, window, heads: int):
        super().__init__()
        wh, ww = window
        self.nx, self.heads = nx, heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), heads))
        self.qkv = Linear(nx, dim, 3 * dim)
        self.proj = Linear(nx, dim, dim)
        self.register_buffer("rel_index", relative_position_index(wh, ww),
                             persistent=False)

    def forward(self, x, mask):
        nbw, n, c = x.shape
        h, d = self.heads, c // self.heads
        qkv = self.qkv(x).reshape(nbw, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
        attn = self.nx.matmul(q, k.transpose(-1, -2))
        bias = self.relative_position_bias_table[self.rel_index.reshape(-1)]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(nbw // nw, nw, h, n, n)
                    + mask[None, :, None]).reshape(nbw, h, n, n)
        ctx = self.nx.matmul(torch.softmax(attn, dim=-1), v)
        return self.proj(ctx.transpose(1, 2).reshape(nbw, n, c))


class SwinBlock(nn.Module):
    def __init__(self, nx: Numerics, dim: int, res, heads: int, window,
                 shift: int, drop_path: float):
        super().__init__()
        h, w = res
        if min(h, w) <= min(window):
            m = min(h, w)
            window, shift = (m, m), 0
        self.res, self.window, self.shift = (h, w), tuple(window), shift
        self.padded = (h + (-h) % window[0], w + (-w) % window[1])
        self.register_buffer(
            "attn_mask", shifted_mask(*self.padded, *window, shift)
            if shift else None, persistent=False)
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.attn = WindowAttention(nx, dim, window, heads)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, LN_EPS)
        self.mlp_fc1 = Linear(nx, dim, 4 * dim)
        self.mlp_fc2 = Linear(nx, 4 * dim, dim)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x):
        (h, w), (hp, wp), s = self.res, self.padded, self.shift
        wh, ww = self.window
        b, l, c = x.shape
        y = optional_pad(self.norm1(x).view(b, h, w, c), wh, ww)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = unpartition(self.attn(partition(y, wh, ww), self.attn_mask),
                        wh, ww, hp, wp)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + self.drop_path1(y[:, :h, :w, :].reshape(b, l, c))
        return x + self.drop_path2(self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x)))))


class PatchMerging(nn.Module):
    def __init__(self, nx: Numerics, dim: int, res):
        super().__init__()
        self.res = res
        self.norm = LayerNorm(4 * dim, LN_EPS)
        self.reduction = Linear(nx, 4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, _, c = x.shape
        x = optional_pad(x.view(b, *self.res, c), 2, 2)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class SwinBackbone(nn.Module):
    def __init__(self, nx: Numerics, img_size, cin: int, embed: int, depths,
                 heads, window, drop_path_rate: float):
        super().__init__()
        self.embed = embed
        self.proj = Conv(nx, cin, embed, PATCH, stride=PATCH, padding="VALID")
        self.patch_norm = LayerNorm(embed, LN_EPS)
        res = (img_size[0] // PATCH, img_size[1] // PATCH)
        rates = np.linspace(0.0, drop_path_rate, sum(depths))
        self.stages, blk = [], 0
        for i, (depth, nh) in enumerate(zip(depths, heads)):
            dim = embed * 2 ** i
            names = []
            for d in range(depth):
                name = f"layer{i}_block{d}"
                self.add_module(name, SwinBlock(
                    nx, dim, res, nh, window,
                    0 if d % 2 == 0 else min(window) // 2, float(rates[blk])))
                names.append(name)
                blk += 1
            merge = None
            if i < len(depths) - 1:
                merge = f"layer{i}_downsample"
                self.add_module(merge, PatchMerging(nx, dim, res))
            self.stages.append((names, merge, res, dim))
            if merge:
                res = ((res[0] + 1) // 2, (res[1] + 1) // 2)
        self.out_res = res
        self.norm = LayerNorm(embed * 2 ** (len(depths) - 1), LN_EPS)

    def forward(self, x):
        b = x.shape[0]
        x = self.patch_norm(self.proj(x).reshape(b, -1, self.embed))
        features = []
        for names, merge, res, dim in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            if merge:
                features.append(x.reshape(b, *res, dim))
                x = getattr(self, merge)(x)
        return self.norm(x).reshape(b, *self.out_res, -1), features


class SwinSegmenter(nn.Module):
    """``[B, H, W, C]`` float32 frames -> ``[B, H, W, classes]``
    probabilities; ``cfg`` is the configuration file's ``model`` object."""

    def __init__(self, cfg: dict, nx: Numerics):
        super().__init__()
        self.nx = nx
        self.img_size = tuple(cfg["img_size"])
        embed, depths = cfg["swin_embed_dim"], tuple(cfg["swin_depths"])
        self.backbone = SwinBackbone(
            nx, self.img_size, cfg["in_channels"], embed, depths,
            tuple(cfg["swin_heads"]), tuple(cfg["window"]),
            cfg["drop_path_rate"])
        dims = [embed * 2 ** i for i in range(len(depths))]
        cin = dims[-1]
        for i, ch in enumerate(reversed(dims[:-1])):
            self.add_module(f"up_{i}", ConvTranspose(nx, cin, ch, 3, 2))
            self.add_module(f"fuse_{i}", Conv(nx, 2 * ch, ch, 3))
            cin = ch
        mid = max(embed // 2, 32)
        self.up_final1 = ConvTranspose(nx, cin, mid, 3, 2)
        self.head = ConvTranspose(nx, mid, cfg["num_classes"], 3, 2)

    def set_generator(self, gen: Optional[torch.Generator]) -> None:
        for m in self.modules():
            if isinstance(m, DropPath):
                m.generator = gen

    def l2_weights(self) -> List[nn.Parameter]:
        return l2_kernels(self, WindowAttention)

    def forward(self, x):
        y, features = self.backbone(x)
        for i, skip in enumerate(reversed(features)):
            y = getattr(self, f"up_{i}")(y)[:, :skip.shape[1], :skip.shape[2]]
            y = gelu(getattr(self, f"fuse_{i}")(torch.cat([y, skip], dim=-1)))
        y = gelu(self.up_final1(y))
        logits = self.head(y)[:, :self.img_size[0], :self.img_size[1]]
        return torch.softmax(logits, dim=-1)


MODEL = SwinSegmenter
