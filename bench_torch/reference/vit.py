"""Plain reference of the pure ViT segmenter (silverlight6/Ultrasound_Modeling,
``TBI_Transformer.py``: ``Embeddings``, ``Block``, ``Encoder``,
``Transformer``), train and eval:

frames ``[B, 256, 80, 10]`` -> a (16, 8) stride-(16, 8) patch conv to a
16x10 grid of 160 tokens of width 1280 -> eight pre-LN transformer blocks
(LayerNorm eps 1e-6, eight heads of width 160, scores scaled by
1/sqrt(heads), the original's quirk, an exact-GELU MLP of width 2048) -> a
final LayerNorm -> the token buffer ``[B, 160, 1280]`` reshaped raw to
``[B, 256, 80, 10]`` (not un-patchified) -> a 3x3 conv head -> softmax over
the three classes.  The blocks are :mod:`reference.transunet`'s, under the
program's names (``block_{i}``).

Departures: no position embedding (the original adds a constant zero), and
neither the conv stem nor a learned position embedding (the port's
extensions, refused by name).  Float32 throughout; every product goes
through ``nx``.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from .layers import Conv, LayerNorm, l2_kernels
from .numerics import Numerics
from .transunet import TRANSFORMER_LN_EPS, Attention, Block


class ViTSegmenter(nn.Module):
    """``[B, H, W, C]`` float32 frames -> ``[B, H, W, classes]``
    probabilities; ``cfg`` is the configuration file's ``model`` object."""

    def __init__(self, cfg: dict, nx: Numerics):
        super().__init__()
        for key in ("vit_conv_stem", "vit_learned_pos"):
            if cfg.get(key):
                raise NotImplementedError(
                    f"model.{key} = {cfg[key]!r}: the reference has no plain "
                    f"version of it")
        self.nx = nx
        h, w = cfg["img_size"]
        gh, gw = cfg["vit_grid"]
        self.img_size, self.hidden = (h, w), cfg["vit_hidden"]
        patch = (h // gh, w // gw)
        self.patch_embeddings = Conv(nx, cfg["in_channels"], self.hidden, patch,
                                     stride=patch, padding="VALID")
        self.num_layers = cfg["vit_layers"]
        for i in range(self.num_layers):
            self.add_module(f"block_{i}", Block(nx, self.hidden, cfg["vit_heads"],
                                                cfg["mlp_dim"]))
        self.encoder_norm = LayerNorm(self.hidden, TRANSFORMER_LN_EPS)
        self.head = Conv(nx, gh * gw * self.hidden // (h * w),
                         cfg["num_classes"], 3)

    def forward(self, x):
        b = x.shape[0]
        emb = self.patch_embeddings(x).reshape(b, -1, self.hidden)
        for i in range(self.num_layers):
            emb = getattr(self, f"block_{i}")(emb)
        feat = self.encoder_norm(emb).reshape(b, *self.img_size, -1)
        return torch.softmax(self.head(feat), dim=-1)

    def l2_weights(self) -> List[nn.Parameter]:
        """The patch conv, every ``fc1`` / ``fc2`` and the head."""
        return l2_kernels(self, Attention)


MODEL = ViTSegmenter
