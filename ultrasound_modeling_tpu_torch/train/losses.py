"""Losses (PyTorch port of ``train/losses.py``); the models emit
probabilities, not logits.  Of the losses, only ``cce_smooth``, the
default, is ported so far; ``l2_regularization`` is the ViT's kernel
penalty."""

from __future__ import annotations

from typing import List, Optional

import torch

from ultrasound_modeling_tpu_torch.utils.checkpoint import flax_path

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


def l2_kernels(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters whose flax leaf (through the weight bridge) is named
    exactly ``kernel``: conv and Dense kernels, ``fc1`` / ``fc2``.  Not the
    attention's ``{query,key,value,out}_kernel``, biases or norm scales —
    the JAX package's leaf rule."""
    return [p for n, p in model.named_parameters()
            if flax_path(n.split("."), p.ndim)[-1] == "kernel"]


def l2_regularization(kernels: List[torch.Tensor],
                      scale: float = 1e-5) -> torch.Tensor:
    """Keras-style L2 kernel regularization summed into the loss
    (``train/losses.l2_regularization``): ``scale * sum(w ** 2)`` over
    ``kernels`` (:func:`l2_kernels`), in float32."""
    return scale * torch.stack([(w.float() * w.float()).sum()
                                for w in kernels]).sum()


def get_loss(name: str):
    if name == "cce_smooth":
        return cce_smooth
    raise NotImplementedError(f"loss {name!r} is not ported yet (only "
                              f"cce_smooth): ROADMAP Queue 1")
