"""Pure ViT segmenter, train and eval (PyTorch port of ``models/vit.py``).

A (16, 8) patch conv turns the ``[B, 256, 80, 10]`` frames into a 16x10
grid of 160 tokens (hidden 1280); position embeddings are constant zeros
(a learnable zero-initialized parameter with ``learned_pos``); 8 pre-LN
blocks (``models/transunet.Block``, score scale 1/sqrt(heads)), the final
LayerNorm, then the token buffer ``[B, 160, 1280]`` is reinterpreted as
``[B, 256, 80, 10]`` (a raw reshape, not an un-patchify), a 3x3 conv head
and a float32 softmax.  ``conv_stem`` puts two 3x3 stride-2 SAME convs with
LeakyReLU(0.2) before a (4, 2) patch conv.

The module tree keeps flax's names (``stem_{i}``, ``patch_embeddings``,
``position_embeddings``, ``block_{i}`` unrolled, ``encoder_norm``,
``head``) for the weight bridge (family ``'vit'``: its ``head`` is a plain
conv).  Routes, as in ``models/transunet.py``: eval under bfloat16 with
``attn_impl='kernel'`` runs the stack through K1, ``encoder_norm`` folded
into the last layer; eval under float32 runs K4 in every Attention (each
sequence one 160-token window, no bias); train mode runs the composed
attention, K3 (``'flash'``) or K5 (``'pallas'``).

Left out: dropout and the JAX ``batch_per_step`` (TPU tiling of K1).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ultrasound_modeling_tpu_torch.models.common import Conv, LayerNorm, leaky
from ultrasound_modeling_tpu_torch.models.transunet import (
    TRANSFORMER_LN_EPS, Block, Segmenter, check_impls, k1_stack)

STEM_CHANNELS = (64, 128)
STEM_SLOPE = 0.2


class ViTSegmenter(Segmenter):
    """Input NHWC ``[B, H, W, in_channels]`` float32 -> probabilities
    ``[B, H, W, num_classes]`` float32.  Params stay float32; activations
    run in ``compute_dtype``."""

    family = "vit"   # the weight bridge's name for this tree

    def __init__(self, num_classes: int = 3, hidden_size: int = 1280,
                 num_heads: int = 8, num_layers: int = 8,
                 grid: Tuple[int, int] = (16, 10),
                 img_size: Tuple[int, int] = (256, 80), mlp_dim: int = 2048,
                 in_channels: int = 10, learned_pos: bool = False,
                 conv_stem: bool = False, attn_impl: str = "kernel",
                 attn_train_impl: str = "composed",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_impls(attn_impl, attn_train_impl)
        h, w = img_size
        gh, gw = grid
        if h % gh or w % gw or (gh * gw * hidden_size) % (h * w):
            raise ValueError(f"grid {grid} does not tile {img_size} with a "
                             f"whole number of channels")
        self.grid, self.img_size = (gh, gw), (h, w)
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.attn_impl = attn_impl
        self.compute_dtype = compute_dtype
        self.conv_stem = conv_stem
        patch = (h // gh, w // gw)
        cin = in_channels
        if conv_stem:
            for i, ch in enumerate(STEM_CHANNELS):
                self.add_module(f"stem_{i}", Conv(cin, ch, 3, stride=2))
                cin = ch
            patch = (patch[0] // 4, patch[1] // 4)
        self.patch_embeddings = Conv(cin, hidden_size, patch, stride=patch,
                                     padding="VALID")
        if learned_pos:
            self.position_embeddings = nn.Parameter(
                torch.zeros(1, gh * gw, hidden_size))
        else:
            self.position_embeddings = None
        for i in range(num_layers):
            self.add_module(f"block_{i}", Block(hidden_size, num_heads, mlp_dim,
                                                attn_impl, attn_train_impl))
        self.encoder_norm = LayerNorm(hidden_size, eps=TRANSFORMER_LN_EPS)
        self.head = Conv(gh * gw * hidden_size // (h * w), num_classes, 3)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.to(self.compute_dtype)
        if self.conv_stem:
            for i in range(len(STEM_CHANNELS)):
                x = leaky(getattr(self, f"stem_{i}")(x), STEM_SLOPE)
        emb = self.patch_embeddings(x).reshape(b, -1, self.hidden_size)
        if self.position_embeddings is not None:
            emb = emb + self.position_embeddings.to(emb.dtype)
        if (not self.training and self.attn_impl != "composed"
                and emb.dtype == torch.bfloat16):
            emb = k1_stack(self.blocks(), self.encoder_norm, emb,
                           self.num_heads)
        else:
            for blk in self.blocks():
                emb = blk(emb)
            emb = self.encoder_norm(emb)
        feat = emb.contiguous().reshape(b, *self.img_size, -1)
        return torch.softmax(self.head(feat).float(), dim=-1)
