"""Batched on-device data augmentation (PyTorch port of ``data/augment.py``).

Each augmentation is a function of explicit per-sample parameters on a
batch ``images [B, H, W, C]``, ``labels [B, H, W]``, so the port is held
against the JAX package op by op with the parameters the JAX keys draw.
``augment_batch`` draws those parameters with the reference's branch
probabilities (``DataAugs.py:82-102``) from an explicit ``torch.Generator``
on the batch's device, and the batch never leaves the device:

  with r, t ~ U{0..100000} per sample:
    * optional horizontal flip if ``r % 2`` (monolith variant),
    * brain-mask erosion by ``t % 7 + 2`` iterations if ``r % 3 != 0``,
    * ``r % 3`` rectangle cutouts (centre row ~ U[0, H], half-height
      U[20, 40], centre col ~ U[0, W], half-width U[10, 20]),
    * a shift by (dr <= 30, dc <= 12) pixels, both + or both -, with zero
      fill, if ``t % 2``,
    * Gaussian noise N(0, 1) / 5000 if ``t % 3 != 0``.

The JAX package shifts with 0/1 permutation matmuls for the TPU's MXU; here
the shift is an index gather with zero fill, which is the same map.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

MAX_ERODE_ITERS = 8  # t % 7 + 2 <= 8

Pair = Tuple[torch.Tensor, torch.Tensor]


def _per_sample(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``[B]`` -> ``[B, 1, ...]`` broadcastable against a rank-``ndim``
    batch."""
    return t.reshape(-1, *([1] * (ndim - 1)))


def erode_brain(image: torch.Tensor, label: torch.Tensor,
                iters: torch.Tensor) -> Pair:
    """Shrink the brain by ``iters[b]`` pixels: grow the outside-brain
    region ``label < 0.1`` by that many 3x3 max-pools (8-neighbourhood
    dilation), zero the label there, then zero every image channel where the
    label is 0."""
    outside = (label < 0.1).to(image.dtype)[:, None]          # [B, 1, H, W]
    n = _per_sample(iters, 4)
    for i in range(MAX_ERODE_ITERS):
        grown = F.max_pool2d(outside, 3, stride=1, padding=1)
        outside = torch.where(i < n, grown, outside)
    label = torch.where(outside[:, 0] < 0.5, label, 0.0)
    image = torch.where((label != 0.0)[..., None], image, 0.0)
    return image, label


def cutout(image: torch.Tensor, label: torch.Tensor, r: torch.Tensor,
           c: torch.Tensor, ra: torch.Tensor, ca: torch.Tensor) -> Pair:
    """Zero image and label inside the open rectangle
    ``r - ra < row < r + ra``, ``c - ca < col < c + ca`` of each sample."""
    _, h, w = label.shape
    rows = torch.arange(h, device=label.device)[None, :, None]
    cols = torch.arange(w, device=label.device)[None, None, :]
    r, c, ra, ca = (_per_sample(v, 3) for v in (r, c, ra, ca))
    inside = ((rows > r - ra) & (rows < r + ra)
              & (cols > c - ca) & (cols < c + ca))
    return (torch.where(inside[..., None], 0.0, image),
            torch.where(inside, 0.0, label))


def shift(image: torch.Tensor, label: torch.Tensor, sr: torch.Tensor,
          sc: torch.Tensor) -> Pair:
    """``out[b, i, j] = in[b, i + sr[b], j + sc[b]]``, zero where the source
    lies outside the frame."""
    b, h, w = label.shape
    dev = label.device
    src_r = torch.arange(h, device=dev)[None, :] + sr[:, None]   # [B, H]
    src_c = torch.arange(w, device=dev)[None, :] + sc[:, None]   # [B, W]
    valid = (((src_r >= 0) & (src_r < h))[:, :, None]
             & ((src_c >= 0) & (src_c < w))[:, None, :])         # [B, H, W]
    bi = torch.arange(b, device=dev)[:, None, None]
    ri = src_r.clamp(0, h - 1)[:, :, None]
    ci = src_c.clamp(0, w - 1)[:, None, :]
    return (torch.where(valid[..., None], image[bi, ri, ci], 0.0),
            torch.where(valid, label[bi, ri, ci], 0.0))


def gaussian_noise(image: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``image + noise / 5000`` with ``noise ~ N(0, 1)`` of image's shape."""
    return image + noise / 5000.0


def hflip(image: torch.Tensor, label: torch.Tensor) -> Pair:
    """Flip along the width axis."""
    return image.flip(2), label.flip(2)


def _pick(on: torch.Tensor, new: Pair, old: Pair) -> Pair:
    return (torch.where(_per_sample(on, 4), new[0], old[0]),
            torch.where(_per_sample(on, 3), new[1], old[1]))


def augment_batch(images: torch.Tensor, labels: torch.Tensor,
                  gen: torch.Generator, flip: bool = False) -> Pair:
    """The reference's augmentation composition on a batch, parameters drawn
    from ``gen`` (a generator on the batch's device)."""
    b, h, w = labels.shape
    dev = labels.device

    def randint(lo: int, hi: int) -> torch.Tensor:  # U{lo .. hi - 1}, [B]
        return torch.randint(lo, hi, (b,), generator=gen, device=dev)

    r, t = randint(0, 100001), randint(0, 100001)
    x = (images, labels)
    if flip:
        x = _pick(r % 2 == 1, hflip(*x), x)
    erode = r % 3 != 0
    x = _pick(erode, erode_brain(*x, torch.where(erode, t % 7 + 2, 0)), x)
    for i in range(2):
        params = (randint(0, h + 1), randint(0, w + 1), randint(20, 41),
                  randint(10, 21))
        x = _pick(i < r % 3, cutout(*x, *params), x)
    dr, dc = randint(0, 31), randint(0, 13)
    sign = torch.where(randint(0, 2) == 1, 1, -1)
    x = _pick(t % 2 == 1, shift(*x, sign * dr, sign * dc), x)
    noise = torch.randn(images.shape, generator=gen, device=dev,
                        dtype=images.dtype)
    image = torch.where(_per_sample(t % 3 != 0, 4),
                        gaussian_noise(x[0], noise), x[0])
    return image, x[1]


def augment_sample(image: torch.Tensor, label: torch.Tensor,
                   gen: torch.Generator, flip: bool = False) -> Pair:
    """One ``[H, W, C]`` / ``[H, W]`` sample through :func:`augment_batch`."""
    im, lb = augment_batch(image[None], label[None], gen, flip)
    return im[0], lb[0]
