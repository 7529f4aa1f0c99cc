"""Label encoding (PyTorch port of ``data/labels.py``).

Soft scalar labels around {0: outside brain, 1: brain, 2: bleed} become a
soft class map with the reference's thresholds 0.95 / 1.05:

  class_2 = min(label - 1, 1)            where label >= 1.05, else 0
  class_1 = 1 - class_2                  where label >  0.95, else 0
  class_0 = 1                            where label <= 0.95, else 0
"""

from __future__ import annotations

import torch


def label2vec(label: torch.Tensor, num_classes: int = 3) -> torch.Tensor:
    """``label [..., H, W]`` -> float32 ``[..., H, W, num_classes]``; 3
    classes (bleed task) or 2 (brain mask: ``[1 - label, label]``)."""
    label = label.float()
    if num_classes == 3:
        class_2 = torch.clamp(torch.where(label >= 1.05, label - 1.0, 0.0),
                              max=1.0)
        class_1 = torch.where(label > 0.95, 1.0 - class_2, 0.0)
        class_0 = torch.where(label <= 0.95, 1.0, 0.0)
        return torch.stack([class_0, class_1, class_2], dim=-1)
    if num_classes == 2:
        return torch.stack([1.0 - label, label], dim=-1)
    raise ValueError(f"num_classes must be 2 or 3, got {num_classes}")


def one_hot_labels(label: torch.Tensor, num_classes: int = 3) -> torch.Tensor:
    """The integer one-hot variant of the MobileUNet pipeline: ``label``
    truncated toward zero to an integer, clipped to ``[0, num_classes -
    1]``, one-hot float32 ``[..., num_classes]``.  The train step uses
    ``label2vec``, as the JAX package's does."""
    idx = label.to(torch.int32).clamp(0, num_classes - 1).long()
    return torch.eye(num_classes, dtype=torch.float32,
                     device=label.device)[idx]
