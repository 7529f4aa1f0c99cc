"""TransUNet, train and eval (PyTorch port of ``models/transunet.py``):
ResNeSt-hybrid patch embedding -> transformer bottleneck -> DecoderCup with
dilated-conv branches and the hidden-state re-concat at every scale.
``module.train()`` / ``module.eval()`` is the JAX package's ``train`` flag.

In eval mode ``attn_impl`` picks the transformer's route, as ``attn_impl``
does in the JAX package ('xla' / 'pallas'):

* ``'kernel'`` — the serving path.  Under bfloat16 the whole stack runs
  through K1 (``ops.kernels.transformer_block``, one call per layer, the
  trailing ``encoder_norm`` folded into the last); under float32 every
  Attention runs K4 (``ops.kernels.window_attention_fused``, each batch
  element one 80-token window, no bias).
* ``'composed'`` — q/k/v/out linears + ``ops.attention.mha``, the JAX
  package's 'xla' path.

In train mode ``attn_train_impl`` picks it, as in the JAX package:
``'composed'`` (the JAX 'xla', autograd through ``mha``), ``'flash'`` (the
qkv projection as one matmul, K3 ``ops.kernels.flash_mha`` with its
backward kernel, the output projection) or ``'pallas'`` (the whole chain
as K5 ``ops.kernels.attention_train_fused``, whose forward saves qkv and
the probabilities for its backward).  Under ``ops.kernels.plain_versions()``
each kernel named here runs its plain PyTorch version.  The BatchNorms
train with batch statistics; in eval each is folded into the conv before
it (``models.common.conv_norm``).

Left out: ``KSACDecoderBlock``, pipeline parallelism, remat, dropout.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ultrasound_modeling_tpu_torch.models.common import (
    Conv, ConvTranspose, LayerNorm, Norm, conv_norm, gelu, leaky)
from ultrasound_modeling_tpu_torch.models.resnest import ResNeStEncoder
from ultrasound_modeling_tpu_torch.ops import kernels
from ultrasound_modeling_tpu_torch.ops.attention import mha
from ultrasound_modeling_tpu_torch.utils.tracing import span

TRANSFORMER_LN_EPS = 1e-6
ATTN_IMPLS = ("kernel", "composed")
ATTN_TRAIN_IMPLS = ("composed", "flash", "pallas")


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


class Attention(nn.Module):
    """MHA with q/k/v/out projections and the 1/sqrt(heads) score scale.
    Under a profiler each train-mode call, on any of the three train
    routes, is the span ``attention.train`` (``utils.tracing``); eval
    opens none."""

    def __init__(self, hidden: int, num_heads: int, attn_impl: str,
                 attn_train_impl: str = "composed"):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.attn_train_impl = attn_train_impl
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def _qkv_weights(self, dt: torch.dtype):
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight])
        b = torch.cat([self.query.bias, self.key.bias, self.value.bias])
        return w.to(dt), b

    def forward(self, x):
        if self.training:
            with span("attention.train"):
                return self._forward(x)
        return self._forward(x)

    def _forward(self, x):
        scale = 1.0 / math.sqrt(self.num_heads)
        if self.training and self.attn_train_impl == "pallas":
            # K5's biases are float32 holding the compute dtype's values
            # (the JAX Attention casts every parameter to it)
            w, b = self._qkv_weights(x.dtype)
            return kernels.attention_train_fused(
                x, w, b.to(x.dtype).float(), self.out.weight.to(x.dtype),
                self.out.bias.to(x.dtype).float(), self.num_heads, scale)
        if self.training and self.attn_train_impl == "flash":
            w, b = self._qkv_weights(x.dtype)
            ctx = kernels.flash_mha(F.linear(x, w, b.to(x.dtype)),
                                    self.num_heads, scale)
            return _linear(ctx, self.out)
        if self.training or self.attn_impl == "composed":
            q, k, v = (_linear(x, m) for m in (self.query, self.key, self.value))
            return _linear(mha(q, k, v, self.num_heads, scale), self.out)
        qkv_w, qkv_b = self._qkv_weights(x.dtype)
        return kernels.window_attention_fused(
            x, qkv_w, qkv_b, self.out.weight.to(x.dtype), self.out.bias,
            self.num_heads, scale=scale)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)

    def forward(self, x):
        return _linear(gelu(_linear(x, self.fc1)), self.fc2)


class Block(nn.Module):
    """Pre-LN transformer block (LN eps 1e-6)."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 attn_impl: str, attn_train_impl: str = "composed"):
        super().__init__()
        self.attention_norm = LayerNorm(hidden, eps=TRANSFORMER_LN_EPS)
        self.attn = Attention(hidden, num_heads, attn_impl, attn_train_impl)
        self.ffn_norm = LayerNorm(hidden, eps=TRANSFORMER_LN_EPS)
        self.ffn = Mlp(hidden, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))

    def k1_weights(self) -> kernels.BlockWeights:
        """This block's weights in K1's contract (bf16 matrices, f32 rest)."""
        a, f, bf = self.attn, self.ffn, torch.bfloat16
        return kernels.BlockWeights(
            self.attention_norm.weight, self.attention_norm.bias,
            torch.cat([a.query.weight, a.key.weight, a.value.weight]).to(bf),
            torch.cat([a.query.bias, a.key.bias, a.value.bias]),
            a.out.weight.to(bf), a.out.bias,
            self.ffn_norm.weight, self.ffn_norm.bias,
            f.fc1.weight.to(bf), f.fc1.bias, f.fc2.weight.to(bf), f.fc2.bias)


def k1_stack(blocks, norm: nn.LayerNorm, x: torch.Tensor,
             num_heads: int) -> torch.Tensor:
    """The bf16 serving stack: each block through K1, the trailing
    LayerNorm ``norm`` folded into the last one."""
    scale = 1.0 / math.sqrt(num_heads)
    x = x.contiguous()
    last = len(blocks) - 1
    for i, blk in enumerate(blocks):
        fin = (norm.weight, norm.bias) if i == last else None
        x = kernels.transformer_block(x, blk.k1_weights(), num_heads, scale,
                                      TRANSFORMER_LN_EPS, final_ln=fin)
    return x


class Encoder(nn.Module):
    """``num_layers`` blocks + the final LN (``encoder_norm``)."""

    def __init__(self, hidden: int, num_heads: int, num_layers: int,
                 mlp_dim: int, attn_impl: str, attn_train_impl: str = "composed"):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.blocks = nn.ModuleList(
            Block(hidden, num_heads, mlp_dim, attn_impl, attn_train_impl)
            for _ in range(num_layers))
        self.encoder_norm = LayerNorm(hidden, eps=TRANSFORMER_LN_EPS)

    def forward(self, x):
        # the K1 stack is an inference kernel: bf16 eval only, as in JAX
        if (not self.training and self.attn_impl != "composed"
                and x.dtype == torch.bfloat16):
            return k1_stack(self.blocks, self.encoder_norm, x, self.num_heads)
        for blk in self.blocks:
            x = blk(x)
        return self.encoder_norm(x)


class DecoderBlock(nn.Module):
    """Transposed-conv upsample + skip concat + two 4-branch dilated conv
    stages (1x1, then 3x3 at dilation 2/4/8), each branch BatchNorm'd,
    concat then LeakyReLU."""

    BRANCHES = ((1, 1), (3, 2), (3, 4), (3, 8))

    def __init__(self, cin: int, cskip: int, out_channels: int):
        super().__init__()
        self.up = ConvTranspose(cin, out_channels, 3, 2)
        cb = out_channels // 4
        for stage, c_in in ((1, out_channels + cskip), (2, out_channels)):
            for b, (k, dil) in enumerate(self.BRANCHES):
                self.add_module(f"conv{stage}_{b}", Conv(c_in, cb, k, dil))
                self.add_module(f"bn{stage}_{b}", Norm("batch", cb))

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        x = self.up(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        for stage in (1, 2):
            x = leaky(torch.cat([
                conv_norm(getattr(self, f"conv{stage}_{b}"),
                          getattr(self, f"bn{stage}_{b}"), x)
                for b in range(len(self.BRANCHES))], dim=-1))
        return x


class DecoderCup(nn.Module):
    """reshape to the token grid -> 3x3 conv + LN + LeakyReLU -> three
    DecoderBlocks, each followed by the hidden states reshaped to its scale
    and concatenated -> 3x3 transposed-conv head -> softmax (float32)."""

    def __init__(self, hidden: int, num_classes: int, grid: Tuple[int, int],
                 head_channels: int = 256,
                 skip_channels: Tuple[int, ...] = (256, 128, 64)):
        super().__init__()
        self.grid = tuple(grid)
        self.conv_more = Conv(hidden, head_channels, 3)
        self.bn1 = Norm("layer", head_channels)
        cin = head_channels
        for i, ch in enumerate(skip_channels):
            self.add_module(f"block_{i}", DecoderBlock(cin, ch, ch))
            cin = ch + hidden // 4 ** (i + 1)   # + re-concat hidden states
        self.n_blocks = len(skip_channels)
        self.head = ConvTranspose(cin, num_classes, 3, 2)

    def forward(self, hidden_states, features: List[torch.Tensor]):
        gh, gw = self.grid
        b = hidden_states.shape[0]
        y = hidden_states
        x = leaky(self.bn1(self.conv_more(y.reshape(b, gh, gw, -1))))
        for i in range(self.n_blocks):
            skip = features[i] if i < len(features) else None
            x = getattr(self, f"block_{i}")(x, skip)
            s = 2 ** (i + 1)
            x = torch.cat([x, y.reshape(b, gh * s, gw * s, -1)], dim=-1)
        return torch.softmax(self.head(x).float(), dim=-1)


class Segmenter(nn.Module):
    """The attention switch shared by the ported families."""

    def set_attn_impl(self, attn_impl: str) -> None:
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        for m in self.modules():
            if hasattr(m, "attn_impl"):
                m.attn_impl = attn_impl


def check_impls(attn_impl: str, attn_train_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one "
                         f"of {ATTN_IMPLS}")
    if attn_train_impl not in ATTN_TRAIN_IMPLS:
        raise ValueError(f"unknown attn_train_impl {attn_train_impl!r}; "
                         f"expected one of {ATTN_TRAIN_IMPLS}")


class TransUNet(Segmenter):
    """Input NHWC ``[B, 256, 80, 10]`` float32 -> probabilities
    ``[B, 256, 80, num_classes]`` float32.  Params stay float32; activations
    run in ``compute_dtype``."""

    family = "transunet"   # the weight bridge's name for this tree

    def __init__(self, num_classes: int = 3, hidden_size: int = 512,
                 num_heads: int = 4, num_layers: int = 8, mlp_dim: int = 2048,
                 grid: Tuple[int, int] = (16, 5), radix: int = 3,
                 kpaths: int = 3, ksize: int = 3, in_channels: int = 10,
                 attn_impl: str = "kernel", attn_train_impl: str = "composed",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_impls(attn_impl, attn_train_impl)
        self.grid = tuple(grid)
        self.hidden_size = hidden_size
        self.compute_dtype = compute_dtype
        self.hybrid = ResNeStEncoder(in_channels, ksize, radix, kpaths)
        self.patch_embeddings = Conv(512, hidden_size, 1)
        self.encoder = Encoder(hidden_size, num_heads, num_layers, mlp_dim,
                               attn_impl, attn_train_impl)
        self.decoder = DecoderCup(hidden_size, num_classes, self.grid)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats, features = self.hybrid(x.to(self.compute_dtype))
        emb = self.patch_embeddings(feats)
        b = emb.shape[0]
        emb = emb.reshape(b, self.grid[0] * self.grid[1], self.hidden_size)
        # position embeddings are constant zeros in the reference: a no-op
        return self.decoder(self.encoder(emb), features)
