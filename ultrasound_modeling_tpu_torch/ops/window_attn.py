"""Windowed (Swin-style) attention helpers (PyTorch port of
``ops/window_attn.py``): window partition and its inverse, the static
relative-position index, the static shifted-window mask, and the plain
window attention that the fused kernel (``ops/kernels.window_attention``)
is held against.

Weights use torch's ``Linear`` layout (``qkv_w [3C, C]``); activations keep
the JAX layout ``[nBW, N, C]`` (nBW = batch * num_windows, window-major
within each batch element).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def window_partition(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B * nH * nW, wh * ww, C]``, windows row-major
    within each batch element."""
    b, h, w, c = x.shape
    wh, ww = window
    x = x.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, c)


def window_reverse(windows: torch.Tensor, window: Tuple[int, int],
                   h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`: ``[B*nH*nW, wh*ww, C]`` ->
    ``[B, H, W, C]``."""
    wh, ww = window
    c = windows.shape[-1]
    x = windows.reshape(-1, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


def relative_position_index(window: Tuple[int, int]) -> np.ndarray:
    """Static ``[wh*ww, wh*ww]`` index into the (2wh-1)(2ww-1) bias table."""
    wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def shifted_window_mask(h: int, w: int, window: Tuple[int, int],
                        shift: int) -> np.ndarray:
    """Static additive mask ``[num_windows, N, N]``: -100 between tokens of
    different pre-shift regions, 0 elsewhere."""
    wh, ww = window
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -shift), slice(-shift, None)):
        for ws in (slice(0, -ww), slice(-ww, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    windows = img.reshape(h // wh, wh, w // ww, ww).transpose(0, 2, 1, 3)
    windows = windows.reshape(-1, wh * ww)
    mask = windows[:, None, :] - windows[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def additive_matrix(num_heads: int, n: int,
                    bias_table: Optional[torch.Tensor] = None,
                    rel_index: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None
                    ) -> Optional[torch.Tensor]:
    """Per-(window mod nW, head) additive score matrix ``[nW, heads, N, N]``
    (float32): the relative-position bias gathered from ``bias_table``
    through ``rel_index`` plus the shifted-window ``mask``.  None when there
    is neither."""
    add = None
    if bias_table is not None:
        bias = bias_table[rel_index.reshape(-1).long()].reshape(n, n, num_heads)
        add = bias.permute(2, 0, 1).float()[None]            # [1, h, N, N]
    if mask is not None:
        m = mask.float()[:, None]                             # [nW, 1, N, N]
        add = m if add is None else add + m
        add = add.expand(mask.shape[0], num_heads, n, n)
    return None if add is None else add.contiguous()


def window_attention(x: torch.Tensor, qkv_w: torch.Tensor,
                     qkv_b: Optional[torch.Tensor],
                     bias_table: Optional[torch.Tensor],
                     rel_index: Optional[torch.Tensor], num_heads: int,
                     mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Window attention over pre-partitioned windows ``x [nBW, N, C]``;
    returns the pre-projection context ``[nBW, N, C]``.  ``scale`` defaults
    to ``d**-0.5``."""
    nbw, n, c = x.shape
    d = c // num_heads
    if scale is None:
        scale = d ** -0.5
    qkv = x @ qkv_w.t()
    if qkv_b is not None:
        qkv = qkv + qkv_b
    qkv = qkv.reshape(nbw, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * scale, qkv[1], qkv[2]
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    add = additive_matrix(num_heads, n, bias_table, rel_index, mask)
    if add is not None:
        nw = add.shape[0]
        attn = (attn.reshape(nbw // nw, nw, num_heads, n, n)
                + add[None]).reshape(nbw, num_heads, n, n)
    probs = torch.softmax(attn, dim=-1).to(v.dtype)
    ctx = torch.matmul(probs.float(), v.float()).to(v.dtype)
    return ctx.transpose(1, 2).reshape(nbw, n, c)
