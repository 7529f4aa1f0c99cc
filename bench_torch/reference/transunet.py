"""Plain reference of the TransUNet hybrid (silverlight6/Ultrasound_Modeling,
``TBI_Transformer.py`` / ``VisionTransformer.py``), inference only:

frames ``[B, 256, 80, 10]`` -> ResNeSt stem (three 3x3 convs, BatchNorm,
LeakyReLU 0.3) -> four split-attention stages (K cardinal paths x R radix
branches; per-branch LayerNorm eps 1e-3 + LeakyReLU; the attention's
softmax over channels, a quirk of the original) each after a 2x average
pool -> a 1x1 patch embed to 80 tokens of width 512 -> eight pre-LN
transformer blocks (LayerNorm eps 1e-6, scores scaled by 1/sqrt(heads),
another quirk, exact GELU) and a final LayerNorm -> the DecoderCup (three
transposed-conv upsamples, skip concatenation, two stages of four dilated
branches each, BatchNorm, the hidden states re-concatenated at every
scale) -> a 3x3 transposed-conv head -> softmax over the three classes.

Everything is float32 and every product goes through ``nx``.  Position
embeddings are zero in the original and are left out.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import (Conv, ConvTranspose, LayerNorm, Linear, Norm, avg_pool2,
                     gelu, group_norm, leaky)
from .numerics import Numerics

TRANSFORMER_LN_EPS = 1e-6


class ResidualS(nn.Module):
    """Split-attention stage with a projected, LayerNorm'd shortcut."""

    def __init__(self, nx: Numerics, cin: int, cout: int, ksize: int,
                 radix: int, kpaths: int):
        super().__init__()
        self.nx, self.k, self.r, self.ksize = nx, kpaths, radix, ksize
        card = cout // 2
        self.c11 = int(card / radix / kpaths)
        self.ckk = int(card / kpaths)
        k, r, c11, ckk = kpaths, radix, self.c11, self.ckk

        def p(*shape):
            return nn.Parameter(torch.zeros(*shape))

        self.branch1_kernel = p(k, r, 1, 1, cin, c11)
        self.branch1_bias = p(k, r, c11)
        self.branch1_norm_scale = p(k, r, c11)
        self.branch1_norm_bias = p(k, r, c11)
        self.branch2_kernel = p(k, r, ksize, ksize, c11, ckk)
        self.branch2_bias = p(k, r, ckk)
        self.branch2_norm_scale = p(k, r, ckk)
        self.branch2_norm_bias = p(k, r, ckk)
        self.attn_dense1_kernel = p(k, ckk, ckk // 2)
        self.attn_dense1_bias = p(k, ckk // 2)
        self.attn_norm_scale = p(k, ckk // 2)
        self.attn_norm_bias = p(k, ckk // 2)
        self.attn_dense2_kernel = p(k, r, ckk // 2, ckk)
        self.attn_dense2_bias = p(k, r, ckk)
        self.concat_conv = Conv(nx, k * ckk, cout, ksize)
        self.shortcut_conv = Conv(nx, cin, cout, 1)
        self.shortcut_norm = Norm("layer", cout)

    def forward(self, x):
        nx, k, r, c11, ckk, ks = (self.nx, self.k, self.r, self.c11, self.ckk,
                                  self.ksize)
        b, h, w, cin = x.shape
        xc = x.permute(0, 3, 1, 2)
        # every (path, radix) branch: a 1x1 conv of the whole input ...
        w1 = self.branch1_kernel.reshape(k * r, cin, c11).permute(0, 2, 1)
        y = nx.conv2d(xc, w1.reshape(k * r * c11, cin, 1, 1),
                      self.branch1_bias.reshape(-1))
        y = leaky(group_norm(y.permute(0, 2, 3, 1), self.branch1_norm_scale,
                             self.branch1_norm_bias, c11))
        # ... then a kxk conv of its own slice
        w2 = self.branch2_kernel.reshape(k * r, ks, ks, c11, ckk)
        w2 = w2.permute(0, 4, 3, 1, 2).reshape(k * r * ckk, c11, ks, ks)
        y = nx.conv2d(y.permute(0, 3, 1, 2), w2, self.branch2_bias.reshape(-1),
                      padding=(ks - 1) // 2, groups=k * r)
        y = leaky(group_norm(y.permute(0, 2, 3, 1), self.branch2_norm_scale,
                             self.branch2_norm_bias, ckk))
        gap = y.mean(dim=(1, 2)).reshape(b, k, r, ckk).sum(2)        # [B,K,ckk]
        a = (torch.einsum("bkc,kcd->bkd", nx.q(gap),
                          nx.q(self.attn_dense1_kernel))
             + self.attn_dense1_bias)
        a = leaky(group_norm(a.reshape(b, -1), self.attn_norm_scale,
                             self.attn_norm_bias, ckk // 2)).reshape(a.shape)
        z = (torch.einsum("bkd,krdc->bkrc", nx.q(a),
                          nx.q(self.attn_dense2_kernel))
             + self.attn_dense2_bias)                                 # [B,K,R,ckk]
        z = torch.softmax(z, dim=-1)             # over channels, as the original
        yz = y.reshape(b, h, w, k, r, ckk) * z.reshape(b, 1, 1, k, r, ckk)
        concats = self.concat_conv(yz.sum(4).reshape(b, h, w, k * ckk))
        return leaky(self.shortcut_norm(self.shortcut_conv(x))) + concats


class ResNeStEncoder(nn.Module):
    def __init__(self, nx: Numerics, cin: int, ksize: int, radix: int,
                 kpaths: int):
        super().__init__()
        self.initial_conv = Conv(nx, cin, 16, 3)
        self.convtmp_1 = Conv(nx, 16, 32, 3)
        self.convtmp_1bn = Norm("batch", 32)
        self.convtmp_2 = Conv(nx, 32, 32, 3)
        self.convtmp_2bn = Norm("batch", 32)
        chans = (32, 64, 128, 256, 512)
        for i in range(4):
            self.add_module(f"stage{i + 1}", ResidualS(
                nx, chans[i], chans[i + 1], ksize, radix, kpaths))

    def forward(self, x):
        x = leaky(self.initial_conv(x))
        x = leaky(self.convtmp_1bn(self.convtmp_1(x)))
        x = leaky(self.convtmp_2bn(self.convtmp_2(x)))
        x1 = self.stage1(avg_pool2(x))
        x2 = self.stage2(avg_pool2(x1))
        x3 = self.stage3(avg_pool2(x2))
        x4 = self.stage4(avg_pool2(x3))
        return x4, [x3, x2, x1]


class Attention(nn.Module):
    def __init__(self, nx: Numerics, hidden: int, heads: int):
        super().__init__()
        self.nx, self.heads = nx, heads
        self.query = Linear(nx, hidden, hidden)
        self.key = Linear(nx, hidden, hidden)
        self.value = Linear(nx, hidden, hidden)
        self.out = Linear(nx, hidden, hidden)

    def forward(self, x):
        b, s, c = x.shape
        h, d = self.heads, c // self.heads

        def split(t):
            return t.reshape(b, s, h, d).transpose(1, 2)

        q, k, v = (split(m(x)) for m in (self.query, self.key, self.value))
        scores = self.nx.matmul(q, k.transpose(-1, -2)) / math.sqrt(h)
        ctx = self.nx.matmul(torch.softmax(scores, dim=-1), v)
        return self.out(ctx.transpose(1, 2).reshape(b, s, c))


class Mlp(nn.Module):
    def __init__(self, nx: Numerics, hidden: int, mlp: int):
        super().__init__()
        self.fc1 = Linear(nx, hidden, mlp)
        self.fc2 = Linear(nx, mlp, hidden)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, nx: Numerics, hidden: int, heads: int, mlp: int):
        super().__init__()
        self.attention_norm = LayerNorm(hidden, TRANSFORMER_LN_EPS)
        self.attn = Attention(nx, hidden, heads)
        self.ffn_norm = LayerNorm(hidden, TRANSFORMER_LN_EPS)
        self.ffn = Mlp(nx, hidden, mlp)

    def forward(self, x):
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class Encoder(nn.Module):
    def __init__(self, nx: Numerics, hidden: int, heads: int, layers: int,
                 mlp: int):
        super().__init__()
        self.blocks = nn.ModuleList(Block(nx, hidden, heads, mlp)
                                    for _ in range(layers))
        self.encoder_norm = LayerNorm(hidden, TRANSFORMER_LN_EPS)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.encoder_norm(x)


class DecoderBlock(nn.Module):
    BRANCHES = ((1, 1), (3, 2), (3, 4), (3, 8))

    def __init__(self, nx: Numerics, cin: int, cskip: int, cout: int):
        super().__init__()
        self.up = ConvTranspose(nx, cin, cout, 3, 2)
        cb = cout // 4
        for stage, c_in in ((1, cout + cskip), (2, cout)):
            for i, (k, dil) in enumerate(self.BRANCHES):
                self.add_module(f"conv{stage}_{i}", Conv(nx, c_in, cb, k, dil))
                self.add_module(f"bn{stage}_{i}", Norm("batch", cb))

    def forward(self, x, skip):
        x = torch.cat([self.up(x), skip], dim=-1)
        for stage in (1, 2):
            x = leaky(torch.cat([
                getattr(self, f"bn{stage}_{i}")(getattr(self, f"conv{stage}_{i}")(x))
                for i in range(len(self.BRANCHES))], dim=-1))
        return x


class DecoderCup(nn.Module):
    def __init__(self, nx: Numerics, hidden: int, classes: int, grid,
                 head_channels: int = 256, skips=(256, 128, 64)):
        super().__init__()
        self.grid = tuple(grid)
        self.conv_more = Conv(nx, hidden, head_channels, 3)
        self.bn1 = Norm("layer", head_channels)
        cin = head_channels
        for i, ch in enumerate(skips):
            self.add_module(f"block_{i}", DecoderBlock(nx, cin, ch, ch))
            cin = ch + hidden // 4 ** (i + 1)
        self.n_blocks = len(skips)
        self.head = ConvTranspose(nx, cin, classes, 3, 2)

    def forward(self, hidden_states, features):
        gh, gw = self.grid
        b = hidden_states.shape[0]
        y = hidden_states
        x = leaky(self.bn1(self.conv_more(y.reshape(b, gh, gw, -1))))
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x, features[i])
            s = 2 ** (i + 1)
            x = torch.cat([x, y.reshape(b, gh * s, gw * s, -1)], dim=-1)
        return torch.softmax(self.head(x), dim=-1)


class TransUNet(nn.Module):
    """``[B, H, W, C]`` float32 frames -> ``[B, H, W, classes]``
    probabilities; ``cfg`` is the configuration file's ``model`` object."""

    def __init__(self, cfg: dict, nx: Numerics):
        super().__init__()
        self.nx = nx
        self.grid, self.hidden = tuple(cfg["grid"]), cfg["hidden_size"]
        self.hybrid = ResNeStEncoder(nx, cfg["in_channels"], cfg["ksize"],
                                     cfg["radix"], cfg["kpaths"])
        self.patch_embeddings = Conv(nx, 512, self.hidden, 1)
        self.encoder = Encoder(nx, self.hidden, cfg["num_heads"],
                               cfg["num_layers"], cfg["mlp_dim"])
        self.decoder = DecoderCup(nx, self.hidden, cfg["num_classes"],
                                  self.grid)

    def forward(self, x):
        feats, features = self.hybrid(x)
        emb = self.patch_embeddings(feats)
        emb = emb.reshape(emb.shape[0], self.grid[0] * self.grid[1],
                          self.hidden)
        return self.decoder(self.encoder(emb), features)


MODEL = TransUNet
