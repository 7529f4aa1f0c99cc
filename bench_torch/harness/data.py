"""Seeded inputs, made on the device in a few large calls: displacement
frames of the ETL's convention (zero outside an elliptic brain, smooth
zero-mean fields of max magnitude 1 inside it, attenuated in a bleed) and
the soft labels around {0: outside, 1: brain, 2: bleed} that go with them
(blurred edges, at least 0.96 inside the brain, 2 in the bleed's core).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _blur(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``[N, C, H, W]``: ``iters`` times the mean of each pixel and its four
    neighbours, wrapping around the edges."""
    k = torch.tensor([[0.0, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.0]],
                     device=x.device) / 5.0
    k = k.expand(x.shape[1], 1, 3, 3)
    for _ in range(iters):
        x = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="circular"), k,
                     groups=x.shape[1])
    return x


def _ellipse(yy, xx, cy, cx, ry, rx):
    return (((yy - cy[:, None, None]) / ry[:, None, None]) ** 2
            + ((xx - cx[:, None, None]) / rx[:, None, None]) ** 2) < 1.0


def frames_and_labels(n: int, h: int, w: int, c: int, gen: torch.Generator,
                      device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x [n, h, w, c], y [n, h, w])`` float32 on ``device``."""
    u = torch.rand(12, n, generator=gen, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    cy, cx = (0.40 + 0.2 * u[0]) * h, (0.40 + 0.2 * u[1]) * w
    ry, rx = (0.28 + 0.12 * u[2]) * h, (0.28 + 0.14 * u[3]) * w
    brain = _ellipse(yy, xx, cy, cx, ry, rx)
    has_bleed = (u[4] < 0.5)[:, None, None]
    bleed = _ellipse(yy, xx, cy + (u[5] - 0.5) * 0.6 * ry,
                     cx + (u[6] - 0.5) * 0.6 * rx,
                     (0.15 + 0.2 * u[7]) * ry, (0.15 + 0.2 * u[8]) * rx)
    bleed = bleed & brain & has_bleed
    label = torch.where(bleed, 2.0, brain.float())
    label = _blur(label[:, None], 4)[:, 0]
    label = torch.where(bleed, 2.0, label)
    label = torch.where(brain, label.clamp(min=0.96), 0.0)
    disp = _blur(torch.randn(n, c, h, w, generator=gen, device=device), 6)
    disp = disp - disp.mean(dim=(2, 3), keepdim=True)
    disp = disp / disp.abs().amax(dim=(2, 3), keepdim=True).clamp(min=1e-12)
    atten = 0.2 + 0.2 * u[9]
    disp = torch.where(bleed[:, None], disp * atten[:, None, None, None], disp)
    disp = torch.where(brain[:, None], disp, 0.0)
    return disp.permute(0, 2, 3, 1).contiguous(), label
