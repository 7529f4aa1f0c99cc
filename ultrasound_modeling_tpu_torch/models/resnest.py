"""ResNeSt split-attention encoder and standalone ResNeSt U-Net, train and
eval (PyTorch port of ``models/resnest.py``: ``ResNeStEncoder``,
``ResidualS(impl='fused')``, ``_Upsample`` and ``ResNeStUNet``).

The stage keeps the flax parameter shapes (``[K, R, ...]`` stacks, K cardinal
paths x R radix branches) so the weight bridge passes them through as they
are, and derives conv weights from them in the forward:

* the K*R 1x1 branch convs read the same input: one dense 1x1 conv to
  ``K*R*c11`` channels;
* the K*R kxk branch convs each read only their own ``c11`` slice: one
  grouped conv with ``groups=K*R`` (the JAX package's block-diagonal dense
  kernel, without the zeros);
* each branch's LayerNorm (the TransUNet's stages) is a per-group norm on
  the flat channel axis with float32 statistics, followed by LeakyReLU: K2
  (``ops.kernels.group_flat_norm``, the activation folded in).  Where a
  gradient is taken it runs with its backward kernel, as the JAX package's
  train lowering runs its Pallas kernel; where none is (serving), its
  forward alone, an op an exported program keeps (on CPU tensors its plain
  version).  The JAX eval lowering is XLA
  (``resnest.py:43-53``) because XLA fuses the normalize into the conv's
  epilogue on the TPU; eager PyTorch fuses nothing, and spelled out in
  PyTorch ops the norm is a dozen f32 passes over the branch output, a
  third of the bytes a bf16 serving forward moves.  The JAX eval
  lowerings' 0/1 selection-matrix group sums are a TPU device for the MXU;
* each branch's BatchNorm (the ResNeStUNet's stages, ELU) is a plain
  per-channel norm of the flat axis: batch statistics in train mode with
  the two-pass biased variance (``yf.var``, not flax ``nn.BatchNorm``'s
  fast one, which the stem and the upsamples keep), computed as
  ``y * a + (b - mean * a)`` with ``a = rsqrt(var + eps) * scale``, as
  JAX orders it; running statistics ``{branch1,branch2,attn}_norm_
  {mean,var}`` (``[K, R, C]`` / ``[K, C]``, momentum 0.99) as buffers;
* split attention: radix-sum -> GAP -> per-path dense -> norm -> act ->
  per-(path, radix) dense -> softmax over CHANNELS (a reference quirk, kept)
  -> radix-weighted sum.  Under BatchNorm the attention norm reduces over
  the batch axis alone.

The stem's BatchNorms train with batch statistics
(``models/common.BatchNorm``).  The ResNeStUNet's upsamples drop half
their activations in train mode (``common.Dropout``, fixed by the
architecture).

Left out: ``impl='vmap'``, remat.
"""

from __future__ import annotations

import torch
from torch import nn

import torch.nn.functional as F

from ultrasound_modeling_tpu_torch.models.common import (
    KERAS_BN_EPS, KERAS_BN_MOMENTUM, KERAS_LN_EPS, LEAKY_ALPHA, Conv,
    ConvTranspose, Dropout, Norm, avg_pool2, conv_nhwc, conv_norm, elu, leaky,
    softmax_f32)
from ultrasound_modeling_tpu_torch.ops import kernels

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


ACTS = {"leaky": leaky, "elu": elu}


class ResidualS(nn.Module):
    """Split-attention residual stage.  ``norm``/``act``: ``'layer'`` /
    ``'leaky'`` (the TransUNet's encoder) or ``'batch'`` / ``'elu'`` (the
    ResNeStUNet's).  The shortcut is projected and normed when
    ``shortcut_always`` (the TransUNet's) or when the channel count changes;
    otherwise the stage adds its input unchanged."""

    def __init__(self, cin: int, outchannel: int, ksize: int = 3,
                 radix: int = 3, kpaths: int = 3, norm: str = "layer",
                 act: str = "leaky", shortcut_always: bool = True):
        super().__init__()
        if norm not in ("layer", "batch"):
            raise ValueError(f"unknown norm {norm!r}")
        k_, r_ = kpaths, radix
        self.norm, self.act = norm, ACTS[act]
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
        if norm == "batch":
            for name, shape in (("branch1_norm", (k_, r_, c11)),
                                ("branch2_norm", (k_, r_, ckk)),
                                ("attn_norm", (k_, ckk // 2))):
                self.register_buffer(f"{name}_mean", torch.zeros(shape))
                self.register_buffer(f"{name}_var", torch.ones(shape))
        self.concat_conv = Conv(k_ * ckk, outchannel, ksize)
        if shortcut_always or cin != outchannel:
            self.shortcut_conv = Conv(cin, outchannel, 1)
            self.shortcut_norm = Norm(norm, outchannel)
        else:
            self.shortcut_conv = None

    def _batch_stats(self, yf: torch.Tensor, name: str, axes):
        """(mean, var) of float32 ``yf`` over ``axes``: in train mode the
        batch's (two-pass biased variance), folded into the running
        statistics ``name_{mean,var}``; in eval the running ones."""
        ra_mean = getattr(self, f"{name}_mean")
        ra_var = getattr(self, f"{name}_var")
        if not self.training:
            return ra_mean.reshape(-1), ra_var.reshape(-1)
        mean = yf.mean(axes)
        zc = yf - mean
        var = (zc * zc).mean(axes)
        with torch.no_grad():
            m = KERAS_BN_MOMENTUM
            ra_mean.copy_(m * ra_mean + (1 - m) * mean.reshape(ra_mean.shape))
            ra_var.copy_(m * ra_var + (1 - m) * var.reshape(ra_var.shape))
        return mean, var

    def _branch_norm(self, y: torch.Tensor, name: str, gsize: int
                     ) -> torch.Tensor:
        """Per-branch norm + activation of the flat ``[B, H, W, K*R*c]``
        branch output.  LayerNorm: K2; BatchNorm: per flat channel."""
        scale = getattr(self, f"{name}_scale")
        bias = getattr(self, f"{name}_bias")
        if self.norm == "batch":
            sflat, bflat = scale.reshape(-1), bias.reshape(-1)
            yf = y.float()
            mean, var = self._batch_stats(yf, name, (0, 1, 2))
            a = torch.rsqrt(var + KERAS_BN_EPS) * sflat
            return self.act((yf * a + (bflat - mean * a)).to(y.dtype))
        return kernels.group_flat_norm(y, scale, bias, gsize, KERAS_LN_EPS,
                                       act="leaky", act_alpha=LEAKY_ALPHA)

    def _attn_norm(self, a: torch.Tensor) -> torch.Tensor:
        """The split attention's norm + activation of ``a [B, K, C]``."""
        if self.norm == "layer":
            b = a.shape[0]
            return leaky(_group_norm(a.reshape(b, -1), self.attn_norm_scale,
                                     self.attn_norm_bias, a.shape[-1])
                         ).reshape(a.shape)
        af = a.float()
        mean, var = self._batch_stats(af, "attn_norm", (0,))
        out = (af - mean.reshape(a.shape[1:])) * torch.rsqrt(
            var.reshape(a.shape[1:]) + KERAS_BN_EPS)
        out = out * self.attn_norm_scale + self.attn_norm_bias
        return self.act(out.to(a.dtype))

    def _split_attention(self, x: torch.Tensor) -> torch.Tensor:
        k_, r_, c11, ckk, ks = self.k, self.r, self.c11, self.ckk, self.ksize
        kr = k_ * r_
        b, h, w, cin = x.shape
        dt = x.dtype
        # [K,R,1,1,cin,c11] -> OIHW [(k,r,c11), cin, 1, 1]
        w1 = self.branch1_kernel.reshape(kr, cin, c11).permute(0, 2, 1)
        y = conv_nhwc(x, w1.reshape(kr * c11, cin, 1, 1),
                      self.branch1_bias.reshape(-1))
        y = self._branch_norm(y, "branch1_norm", c11)
        # [K,R,k,k,c11,ckk] -> grouped OIHW [(k,r,ckk), c11, k, k]
        w2 = self.branch2_kernel.reshape(kr, ks, ks, c11, ckk)
        w2 = w2.permute(0, 4, 3, 1, 2).reshape(kr * ckk, c11, ks, ks)
        y = conv_nhwc(y, w2, self.branch2_bias.reshape(-1), groups=kr)
        y = self._branch_norm(y, "branch2_norm", ckk)
        # y: [B, H, W, K*R*ckk], flat channel order (k, r, c)
        gap = y.mean(dim=(1, 2)).reshape(b, k_, r_, ckk).sum(2)   # [B,K,ckk]
        a = (torch.einsum("bkc,kcd->bkd", gap, self.attn_dense1_kernel.to(dt))
             + self.attn_dense1_bias.to(dt))
        a = self._attn_norm(a)
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
        if self.shortcut_conv is None:
            return x + concats
        sc = self.act(conv_norm(self.shortcut_conv, self.shortcut_norm, x))
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
        x = leaky(conv_norm(self.convtmp_1, self.convtmp_1bn, x))
        x = leaky(conv_norm(self.convtmp_2, self.convtmp_2bn, x))
        x = avg_pool2(x)
        x1 = self.stage1(x)
        x2 = self.stage2(avg_pool2(x1))
        x3 = self.stage3(avg_pool2(x2))
        x4 = self.stage4(avg_pool2(x3))
        return x4, [x3, x2, x1]



class _Upsample(nn.Module):
    """ConvTranspose(k4, s2) -> BatchNorm -> [dropout 0.5] -> ReLU."""

    def __init__(self, cin: int, cout: int, apply_dropout: bool = False):
        super().__init__()
        self.t_conv = ConvTranspose(cin, cout, 4, 2)
        self.bn = Norm("batch", cout)
        self.Dropout_0 = Dropout(0.5) if apply_dropout else None

    def forward(self, x):
        x = conv_norm(self.t_conv, self.bn, x)
        if self.Dropout_0 is not None:
            x = self.Dropout_0(x)
        return F.relu(x)


class ResNeStUNet(nn.Module):
    """Standalone ResNeSt U-Net: input NHWC ``[B, H, W, in_channels]``
    float32 with H and W divisible by 64 (six 2x average pools; the default
    config trains at 256x64x6) -> probabilities ``[B, H, W, num_classes]``
    float32.  All-BatchNorm with ELU: a three-conv stem, five split-attention
    stages (64, 128, 256, 512, 512 channels, the shortcut projected only
    where the width changes), five k4 s2 transposed-conv upsamples with skip
    concatenations (dropout 0.5 on the first three) and a transposed-conv
    head.  Params stay float32; activations run in ``compute_dtype``; the
    softmax runs in float32."""

    family = "resnest_unet"   # the weight bridge's name for this tree

    def __init__(self, num_classes: int = 3, ksize: int = 3, radix: int = 3,
                 kpaths: int = 3, in_channels: int = 6,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv(in_channels, 16, 3)
        self.conv2_1_1 = Conv(16, 32, 3)
        self.conv2_1_2 = Conv(32, 32, 3)
        self.conv2_1_2bn = Norm("batch", 32)
        rs = dict(ksize=ksize, radix=radix, kpaths=kpaths, norm="batch",
                  act="elu", shortcut_always=False)
        for name, cin, cout in (("conv2_1", 32, 64), ("conv2_2", 64, 128),
                                ("conv3_1", 128, 256), ("conv3_2", 256, 512),
                                ("conv4_1", 512, 512)):
            self.add_module(name, ResidualS(cin, cout, **rs))
        # (input width, output width, dropout): each upsample's output is
        # concatenated with the pooled map of the stage before
        for i, (cin, cout, drop) in enumerate((
                (512, 512, True), (1024, 512, True), (768, 512, True),
                (640, 256, False), (320, 128, False))):
            self.add_module(f"upsample_{i}", _Upsample(cin, cout, drop))
        self.f_tran = ConvTranspose(160, num_classes, 4, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = elu(self.conv1(x.to(self.compute_dtype)))
        x = elu(self.conv2_1_1(x))    # no BatchNorm on this conv
        x = elu(conv_norm(self.conv2_1_2, self.conv2_1_2bn, x))
        pools = [avg_pool2(x)]
        for name in ("conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv4_1"):
            pools.append(avg_pool2(getattr(self, name)(pools[-1])))
        u = pools[-1]
        for i, skip in enumerate(reversed(pools[:-1])):
            u = torch.cat([getattr(self, f"upsample_{i}")(u), skip], dim=-1)
        return softmax_f32(self.f_tran(u))
