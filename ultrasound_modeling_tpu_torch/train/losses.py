"""Losses (PyTorch port of ``train/losses.py``); the models emit
probabilities, not logits.  Only ``cce_smooth``, the default, is ported so
far."""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-7


def cce_smooth(y_true: torch.Tensor, probs: torch.Tensor,
               label_smoothing: float = 0.1,
               global_batch_size: Optional[int] = None) -> torch.Tensor:
    """Keras ``CategoricalCrossentropy(label_smoothing)`` per pixel on
    probabilities clipped to ``[1e-7, 1 - 1e-7]``, summed over pixels and
    divided by the (global) batch size."""
    c = y_true.shape[-1]
    y = y_true * (1.0 - label_smoothing) + label_smoothing / c
    p = torch.clamp(probs, _EPS, 1.0 - _EPS)
    per_pixel = -(y * torch.log(p)).sum(-1)
    return per_pixel.sum() / (global_batch_size or y_true.shape[0])


def get_loss(name: str):
    if name == "cce_smooth":
        return cce_smooth
    raise NotImplementedError(f"loss {name!r} is not ported yet (only "
                              f"cce_smooth): ROADMAP Queue 1")
