"""MobileNetV2 U-Net, train and eval (PyTorch port of
``models/mobileunet.py``; the reference calls it "PixelCNN").

Encoder (``encoder``, the name the dual-rate Adam splits the parameters
on): a 3x3 stride-2 stem conv to 32 channels, 16 inverted residuals with
expansion 6 (block 0 has no expand conv) and a 1x1 conv to 1280.  The
stride-2 stem and depthwise convs pad (1, 1) on each side, as the
reference's ZeroPadding2D(1) + VALID does; flax's SAME would pad (0, 1) at
even sizes, a one-pixel shift.  The depthwise convs are grouped convs
(``groups = channels``).  The skip taps are the expand outputs of blocks
1, 3, 6 and 12 and the final ``out_relu``.

Decoder: four k3 s2 transposed-conv upsamples without bias
(``decoder_up_{i}``: 512, 512, 256, 128 channels, dropout 0.5 on the first
three) with skip concatenations, and a k3 s2 transposed-conv head with
bias (``decoder_head``).  The reference defines a fifth upsample that its
``zip`` with four skips never runs; it is left out here as in JAX.

Params stay float32; activations run in ``compute_dtype``; the softmax
runs in float32.  The BatchNorms train with batch statistics
(``models/common.BatchNorm``).  No kernel of ``ops/kernels.py`` lies on
this family's path.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ultrasound_modeling_tpu_torch.models.common import (
    Conv, ConvTranspose, Dropout, Norm, conv_norm, relu6, softmax_f32)

# (filters, stride) per inverted-residual block
BLOCK_TABLE = (
    (16, 1), (24, 2), (24, 1), (32, 2), (32, 1), (32, 1),
    (64, 2), (64, 1), (64, 1), (64, 1), (96, 1), (96, 1),
    (96, 2), (160, 1), (160, 1), (160, 1))
# skip taps: the expand output of these blocks, then the final out_relu
SKIP_BLOCKS = (1, 3, 6, 12)
SYMMETRIC_PAD = ((1, 1), (1, 1))


class InvertedResidual(nn.Module):
    """[1x1 expand -> BN -> ReLU6] -> 3x3 depthwise -> BN -> ReLU6 -> 1x1
    project (no activation), plus the input where the width and size
    stay; returns (output, the expand output or None)."""

    def __init__(self, cin: int, filters: int, stride: int,
                 expansion: int = 6, block_id: int = 0):
        super().__init__()
        ch = cin
        if block_id:
            ch = expansion * cin
            self.expand = Conv(cin, ch, 1, use_bias=False)
            self.expand_bn = Norm("batch", ch)
        else:
            self.expand = None
        pad = "SAME" if stride == 1 else SYMMETRIC_PAD
        self.depthwise = Conv(ch, ch, 3, stride=stride, padding=pad,
                              groups=ch, use_bias=False)
        self.depthwise_bn = Norm("batch", ch)
        self.project = Conv(ch, filters, 1, use_bias=False)
        self.residual = cin == filters and stride == 1

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        inputs, expand_out = x, None
        if self.expand is not None:
            x = expand_out = relu6(conv_norm(self.expand, self.expand_bn, x))
        x = relu6(conv_norm(self.depthwise, self.depthwise_bn, x))
        x = self.project(x)
        return (inputs + x if self.residual else x), expand_out


class MobileNetV2Encoder(nn.Module):
    """Returns the skip taps, the bottleneck (``out_relu``) last."""

    def __init__(self, in_channels: int = 15, expansion: int = 6):
        super().__init__()
        self.conv1 = Conv(in_channels, 32, 3, stride=2, padding=SYMMETRIC_PAD)
        cin = 32
        for i, (filters, stride) in enumerate(BLOCK_TABLE):
            self.add_module(f"block_{i}", InvertedResidual(
                cin, filters, stride, expansion, block_id=i))
            cin = filters
        self.conv_2 = Conv(cin, 1280, 1, use_bias=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = relu6(self.conv1(x))
        skips = []
        for i in range(len(BLOCK_TABLE)):
            x, expand_out = getattr(self, f"block_{i}")(x)
            if i in SKIP_BLOCKS:
                skips.append(expand_out)
        skips.append(relu6(self.conv_2(x)))
        return skips


class _Upsample(nn.Module):
    """pix2pix upsample: ConvTranspose(k3, s2, no bias) -> BatchNorm ->
    [dropout 0.5] -> ReLU."""

    def __init__(self, cin: int, filters: int, apply_dropout: bool = False):
        super().__init__()
        self.t_conv = ConvTranspose(cin, filters, 3, 2, use_bias=False)
        self.bn = Norm("batch", filters)
        self.Dropout_0 = Dropout(0.5) if apply_dropout else None

    def forward(self, x):
        x = conv_norm(self.t_conv, self.bn, x)
        if self.Dropout_0 is not None:
            x = self.Dropout_0(x)
        return F.relu(x)


class MobileUNet(nn.Module):
    """Input NHWC ``[B, H, W, in_channels]`` float32 with H and W divisible
    by 32 (the default config: 256x64x15) -> probabilities ``[B, H, W,
    num_classes]`` float32."""

    family = "mobileunet"   # the weight bridge's name for this tree

    def __init__(self, num_classes: int = 3, in_channels: int = 15,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.encoder = MobileNetV2Encoder(in_channels)
        expand = 6
        skip_ch = [expand * BLOCK_TABLE[i - 1][0] for i in SKIP_BLOCKS]
        cin = 1280
        for i, ((filters, drop), skip) in enumerate(zip(
                ((512, True), (512, True), (256, True), (128, False)),
                reversed(skip_ch))):
            self.add_module(f"decoder_up_{i}", _Upsample(cin, filters, drop))
            cin = filters + skip
        self.decoder_head = ConvTranspose(cin, num_classes, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = self.encoder(x.to(self.compute_dtype))
        y = skips[-1]
        for i, skip in enumerate(reversed(skips[:-1])):
            y = torch.cat([getattr(self, f"decoder_up_{i}")(y), skip], dim=-1)
        return softmax_f32(self.decoder_head(y))
