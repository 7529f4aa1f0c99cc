"""ResNeSt split-attention encoder, train and eval (PyTorch port of
``models/resnest.py``: ``ResNeStEncoder`` and ``ResidualS(impl='fused')``).

The stage keeps the flax parameter shapes (``[K, R, ...]`` stacks, K cardinal
paths x R radix branches) so the weight bridge passes them through as they
are, and derives conv weights from them in the forward:

* the K*R 1x1 branch convs read the same input: one dense 1x1 conv to
  ``K*R*c11`` channels;
* the K*R kxk branch convs each read only their own ``c11`` slice: one
  grouped conv with ``groups=K*R`` (the JAX package's block-diagonal dense
  kernel, without the zeros);
* each branch's LayerNorm is a per-group norm on the flat channel axis with
  float32 statistics, followed by LeakyReLU.  In train mode it is K2
  (``ops.kernels.group_flat_norm``, the activation folded in, with its
  backward kernel), as the JAX package's train lowering runs its Pallas
  kernel; in eval mode it is plain PyTorch, as the JAX eval lowering is
  XLA (``resnest.py:52-53``).  The JAX eval lowerings' 0/1
  selection-matrix group sums are a TPU device for the MXU;
* split attention: radix-sum -> GAP -> per-path dense -> LN -> LeakyReLU ->
  per-(path, radix) dense -> softmax over CHANNELS (a reference quirk, kept)
  -> radix-weighted sum.

``train_route`` picks K2 (``'kernel'``) or its plain PyTorch version
differentiated by autograd (``'plain'``, the reference the kernel route is
held against on the card).  The stem's BatchNorms train with batch
statistics (``models/common.BatchNorm``).

Left out: ``impl='vmap'``, the BatchNorm/ELU ``ResNeStUNet``.
"""

from __future__ import annotations

import torch
from torch import nn

from ultrasound_modeling_tpu_torch.models.common import (
    KERAS_LN_EPS, LEAKY_ALPHA, Conv, Norm, avg_pool2, conv_nhwc, leaky)
from ultrasound_modeling_tpu_torch.ops import kernels

TRAIN_ROUTES = ("kernel", "plain")


def _group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                gsize: int) -> torch.Tensor:
    """Per-group LayerNorm (eps 1e-3) of the flat last axis of ``y``, groups
    of ``gsize`` contiguous channels, float32 statistics; ``scale``/``bias``
    hold one value per flat channel (any shape).  Returns y's dtype."""
    shape = y.shape
    yg = y.float().reshape(*shape[:-1], shape[-1] // gsize, gsize)
    mu = yg.mean(-1, keepdim=True)
    zc = yg - mu
    var = (zc * zc).mean(-1, keepdim=True)
    out = (zc * torch.rsqrt(var + KERAS_LN_EPS)).reshape(shape)
    return (out * scale.reshape(-1) + bias.reshape(-1)).to(y.dtype)


class ResidualS(nn.Module):
    """Split-attention residual stage with a projected, normed shortcut
    (LayerNorm blocks, LeakyReLU)."""

    def __init__(self, cin: int, outchannel: int, ksize: int = 3,
                 radix: int = 3, kpaths: int = 3):
        super().__init__()
        k_, r_ = kpaths, radix
        self.train_route = "kernel"
        card = outchannel // 2
        self.k, self.r, self.ksize = k_, r_, ksize
        self.c11 = int(card / r_ / k_)
        self.ckk = int(card / k_)
        c11, ckk = self.c11, self.ckk

        def p(*shape):
            return nn.Parameter(torch.zeros(*shape))

        self.branch1_kernel = p(k_, r_, 1, 1, cin, c11)
        self.branch1_bias = p(k_, r_, c11)
        self.branch1_norm_scale = p(k_, r_, c11)
        self.branch1_norm_bias = p(k_, r_, c11)
        self.branch2_kernel = p(k_, r_, ksize, ksize, c11, ckk)
        self.branch2_bias = p(k_, r_, ckk)
        self.branch2_norm_scale = p(k_, r_, ckk)
        self.branch2_norm_bias = p(k_, r_, ckk)
        self.attn_dense1_kernel = p(k_, ckk, ckk // 2)
        self.attn_dense1_bias = p(k_, ckk // 2)
        self.attn_norm_scale = p(k_, ckk // 2)
        self.attn_norm_bias = p(k_, ckk // 2)
        self.attn_dense2_kernel = p(k_, r_, ckk // 2, ckk)
        self.attn_dense2_bias = p(k_, r_, ckk)
        self.concat_conv = Conv(k_ * ckk, outchannel, ksize)
        self.shortcut_conv = Conv(cin, outchannel, 1)
        self.shortcut_norm = Norm("layer", outchannel)

    def _branch_norm(self, y: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, gsize: int) -> torch.Tensor:
        """Per-branch LayerNorm + LeakyReLU of the flat ``[B, H, W, K*R*c]``
        branch output: K2 in train mode, plain PyTorch in eval."""
        if not self.training:
            return leaky(_group_norm(y, scale, bias, gsize))
        fn = (kernels.group_flat_norm if self.train_route == "kernel"
              else kernels.group_flat_norm_plain)
        return fn(y, scale, bias, gsize, KERAS_LN_EPS, act="leaky",
                  act_alpha=LEAKY_ALPHA)

    def _split_attention(self, x: torch.Tensor) -> torch.Tensor:
        k_, r_, c11, ckk, ks = self.k, self.r, self.c11, self.ckk, self.ksize
        kr = k_ * r_
        b, h, w, cin = x.shape
        dt = x.dtype
        # [K,R,1,1,cin,c11] -> OIHW [(k,r,c11), cin, 1, 1]
        w1 = self.branch1_kernel.reshape(kr, cin, c11).permute(0, 2, 1)
        y = conv_nhwc(x, w1.reshape(kr * c11, cin, 1, 1),
                      self.branch1_bias.reshape(-1))
        y = self._branch_norm(y, self.branch1_norm_scale,
                              self.branch1_norm_bias, c11)
        # [K,R,k,k,c11,ckk] -> grouped OIHW [(k,r,ckk), c11, k, k]
        w2 = self.branch2_kernel.reshape(kr, ks, ks, c11, ckk)
        w2 = w2.permute(0, 4, 3, 1, 2).reshape(kr * ckk, c11, ks, ks)
        y = conv_nhwc(y, w2, self.branch2_bias.reshape(-1), groups=kr)
        y = self._branch_norm(y, self.branch2_norm_scale,
                              self.branch2_norm_bias, ckk)
        # y: [B, H, W, K*R*ckk], flat channel order (k, r, c)
        gap = y.mean(dim=(1, 2)).reshape(b, k_, r_, ckk).sum(2)   # [B,K,ckk]
        a = (torch.einsum("bkc,kcd->bkd", gap, self.attn_dense1_kernel.to(dt))
             + self.attn_dense1_bias.to(dt))
        a = leaky(_group_norm(a.reshape(b, -1), self.attn_norm_scale,
                              self.attn_norm_bias, ckk // 2)).reshape(a.shape)
        z = (torch.einsum("bkd,krdc->bkrc", a, self.attn_dense2_kernel.to(dt))
             + self.attn_dense2_bias.to(dt))                       # [B,K,R,ckk]
        if r_ == 1:
            z = torch.sigmoid(z.float())
        else:
            z = torch.softmax(z.float(), dim=-1)  # channel-axis (ref. quirk)
        yz = y.reshape(b, h, w, k_, r_, ckk) * z.to(dt).reshape(b, 1, 1, k_, r_, ckk)
        return yz.sum(4).reshape(b, h, w, k_ * ckk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        concats = self.concat_conv(self._split_attention(x))
        sc = leaky(self.shortcut_norm(self.shortcut_conv(x)))
        return sc + concats


class ResNeStEncoder(nn.Module):
    """TransUNet hybrid stem: stem convs (BatchNorm) -> 4x (avg-pool +
    split-attention stage).  Returns ``(x4, [x3, x2, x1])``: the bottleneck
    at 1/16 resolution and the skips at 1/8, 1/4, 1/2."""

    def __init__(self, in_channels: int = 10, ksize: int = 3, radix: int = 3,
                 kpaths: int = 3):
        super().__init__()
        self.initial_conv = Conv(in_channels, 16, 3)
        self.convtmp_1 = Conv(16, 32, 3)
        self.convtmp_1bn = Norm("batch", 32)
        self.convtmp_2 = Conv(32, 32, 3)
        self.convtmp_2bn = Norm("batch", 32)
        chans = (32, 64, 128, 256, 512)
        for i in range(4):
            self.add_module(f"stage{i + 1}", ResidualS(
                chans[i], chans[i + 1], ksize, radix, kpaths))

    def forward(self, x):
        x = leaky(self.initial_conv(x))
        x = leaky(self.convtmp_1bn(self.convtmp_1(x)))
        x = leaky(self.convtmp_2bn(self.convtmp_2(x)))
        x = avg_pool2(x)
        x1 = self.stage1(x)
        x2 = self.stage2(avg_pool2(x1))
        x3 = self.stage3(avg_pool2(x2))
        x4 = self.stage4(avg_pool2(x3))
        return x4, [x3, x2, x1]

