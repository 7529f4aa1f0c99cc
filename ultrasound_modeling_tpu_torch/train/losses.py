"""Losses (PyTorch port of ``train/losses.py``); the models emit
probabilities, not logits.  Each returns a float32 scalar:

* ``cce_smooth`` (the default): smoothed categorical cross-entropy,
  averaged over the (global) batch;
* ``class_balanced`` (the ResNeStUNet's): per-class inverse-frequency
  scaling per pixel;
* ``factor_scaled``: constant class factors with manual smoothing;
* ``pixelcnn`` (the MobileUNet's) and ``evaluator``: per-class scaled CE
  with the training and the inference-side factors.

``l2_regularization`` is the ViT's kernel penalty.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ultrasound_modeling_tpu_torch.utils.checkpoint import flax_path

DEFAULT_CLASS_FACTOR = (0.06329, 0.027567, 0.90914)
EVAL_CLASS_FACTOR = (1.1603, 0.50832, 5.8513)
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


def class_balanced(y_true: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Inverse-frequency class-balanced CE: per class c, ``scale = 1 /
    (sum_b y_c + 1) / (H * W)`` (an ``[H, W]`` map), ``CE_c = sum_b y_c *
    log(p_c + 1e-7) * scale``; loss ``-sum_{h,w} sum_c CE_c``."""
    h, w = y_true.shape[1], y_true.shape[2]
    ce = torch.zeros((h, w), dtype=torch.float32, device=probs.device)
    for c in range(y_true.shape[-1]):
        yc = y_true[..., c]
        scale = 1.0 / (yc.sum(0) + 1.0) / (h * w)
        ce = ce + (yc * torch.log(probs[..., c] + _EPS)).sum(0) * scale
    return -ce.sum()


def _factors(class_factor: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(class_factor, dtype=torch.float32, device=like.device)


def factor_scaled(y_true: torch.Tensor, probs: torch.Tensor,
                  class_factor: Sequence[float] = DEFAULT_CLASS_FACTOR,
                  smoothing: float = 0.1) -> torch.Tensor:
    """Constant-class-factor CE with manual smoothing: ``-3 * sum y' *
    log(clip(p, 1e-7, 1 - 1e-7)) * factor[c]``, ``y' = y * (1 - s) + s /
    C``."""
    c = y_true.shape[-1]
    y = y_true * (1.0 - smoothing) + smoothing / c
    p = torch.clamp(probs, _EPS, 1.0 - _EPS)
    return -3.0 * (y * torch.log(p) * _factors(class_factor, probs)).sum()


def pixelcnn_loss(y_true: torch.Tensor, probs: torch.Tensor,
                  class_factor: Sequence[float] = DEFAULT_CLASS_FACTOR
                  ) -> torch.Tensor:
    """Per-class scaled CE: ``CE_c = sum(y_c * log(clip(p_c, 1e-7, 1))) /
    (sum y_c + 1) * factor[c]``; loss ``-sum_c CE_c``."""
    cf = _factors(class_factor, probs)
    ce = 0.0
    for c in range(y_true.shape[-1]):
        yc = y_true[..., c]
        pc = torch.clamp(probs[..., c], _EPS, 1.0)
        scale = 1.0 / (yc.sum() + 1.0)
        ce = ce + (yc * torch.log(pc)).sum() * scale * cf[c]
    return -ce


def evaluator_loss(y_true: torch.Tensor, probs: torch.Tensor,
                   class_factor: Sequence[float] = EVAL_CLASS_FACTOR
                   ) -> torch.Tensor:
    """The inference-side variant: ``-3 * sum_c sum(y_c * log(clip(p_c,
    1e-7, 1))) / sum(y) * factor[c]``."""
    cf = _factors(class_factor, probs)
    scale = 1.0 / y_true.sum()
    ce = 0.0
    for c in range(y_true.shape[-1]):
        pc = torch.clamp(probs[..., c], _EPS, 1.0)
        ce = ce + (y_true[..., c] * torch.log(pc)).sum() * scale * cf[c]
    return -3.0 * ce


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


LOSSES = {
    "cce_smooth": cce_smooth,
    "class_balanced": class_balanced,
    "factor_scaled": factor_scaled,
    "pixelcnn": pixelcnn_loss,
    "evaluator": evaluator_loss,
}


def get_loss(name: str):
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
    return LOSSES[name]
