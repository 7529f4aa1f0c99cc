"""Polar-cone rendering of the port: ``ultrasound_modeling_tpu/infer/render.py``
copied as it is (numpy, with matplotlib imported inside the functions, so
importing this module needs no matplotlib), so that the port imports nothing
of the JAX package.

Reproduces the reference's 2x2 panel figure (reference: TBIEvaluator.py:276-355
``Display``): prediction / truth / bleed-probability / bMode, each drawn as a
``pcolormesh`` over the precomputed polar x/y axis grids from the ETL
(reference: DataFilePlayGround.py:86-100 FetchPolarAxis; axes stored as
``xAxis.npy``/``yAxis.npy``), magma colormap, inverted y-axis, bMode windowed
to its histogram's [2, -2] bin edges (TBIEvaluator.py:336-339).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def default_axes(height: int = 256, width: int = 80):
    """Synthetic cone axes for when no ETL axis files exist: a fan of rays
    (the real geometry comes from FetchPolarAxis)."""
    import math
    theta = np.linspace(-math.pi / 4, math.pi / 4, width + 1)
    r = np.linspace(20.0, 140.0, height + 1)
    rr, tt = np.meshgrid(r, theta, indexing="ij")
    x = rr * np.sin(tt) + 100.0
    y = rr * np.cos(tt) - 4.0
    return x, y


def load_axes(axis_dir: str):
    # astype(int) preserved from the reference (TBIEvaluator.py:23-24).
    x = np.load(os.path.join(axis_dir, "xAxis.npy")).astype(int)
    y = np.load(os.path.join(axis_dir, "yAxis.npy")).astype(int)
    return x, y


def render_panels(out_path: str, prob_composite: np.ndarray,
                  truth: np.ndarray,
                  prob_bleed: Optional[np.ndarray] = None,
                  bmode: Optional[np.ndarray] = None,
                  mask: Optional[np.ndarray] = None,
                  diff: bool = False,
                  confusion: Optional[np.ndarray] = None,
                  axes=None, title: str = "") -> str:
    """Write the polar panel PNG (up to 6 panels in a grid); returns the path.

    Panel set mirrors the reference's dispDict options
    (reference: TBIEvaluator.py:30-38,276-355): prediction / truth /
    bleed-probability / bMode / brain-mask / prediction-truth difference /
    confusion matrix.
    """
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    if axes is None:
        xa, ya = default_axes(*prob_composite.shape)
    else:
        xa, ya = axes
    cmap = "magma"

    panels = [("Prediction", prob_composite, dict(vmin=0, vmax=2, cmap=cmap)),
              (title or "Truth", truth, dict(vmin=0, vmax=2, cmap=cmap))]
    if prob_bleed is not None:
        panels.append(("Probability Bleed", prob_bleed,
                       dict(vmin=0, vmax=1, cmap=cmap)))
    if bmode is not None:
        # bMode sign-flipped and windowed (reference: TBIEvaluator.py:247,336-339)
        b = -np.asarray(bmode)
        _, edges = np.histogram(b, bins=25)
        panels.append(("bMode", b,
                       dict(vmin=edges[2], vmax=edges[-2], cmap="binary")))
    if mask is not None:
        panels.append(("Brain_Mask", mask, dict(cmap=cmap)))
    if diff:
        # Difference map — intent of reference TBIEvaluator.py:309-317: 1
        # where predicted CLASS and true CLASS disagree, 2 where a true
        # bleed was missed.  (The reference compares the raw float
        # composite to the raw soft label with `!=`, which flags nearly
        # every pixel — a latent quirk, not the intent.)  Classes are
        # recovered from the composite's {0, 0.5, 2} class levels and the
        # scalar label's argmax-consistent thresholds (data/labels.py).
        pr = np.where(prob_composite > 1.25, 2.0,
                      np.where(prob_composite > 0.25, 1.0, 0.0))
        tr = np.where(truth > 1.5, 2.0, np.where(truth > 0.95, 1.0, 0.0))
        d = np.where(pr != tr, 1.0, 0.0)
        d = np.where((tr == 2.0) & (pr != 2.0), 2.0, d)
        panels.append(("Difference", d, dict(vmin=0, vmax=2, cmap=cmap)))

    n = len(panels) + (1 if confusion is not None else 0)
    rows = (n + 1) // 2
    fig, ax = plt.subplots(rows, 2, figsize=(10, 3 * rows), squeeze=False)
    fig.tight_layout(rect=[0, 0, 1, 0.97])
    fig.subplots_adjust(hspace=0.25, wspace=0.3, bottom=0.1)

    for i, (name, img, kw) in enumerate(panels):
        a = ax[i // 2, i % 2]
        a.grid(False)
        # The reference passes image-shaped (256, 80) axes with
        # shading='flat' (TBIEvaluator.py:287), which old matplotlib
        # accepted by dropping the last row/col and matplotlib >= 3.5
        # rejects.  'auto' keeps both geometries working: 'nearest' for
        # image-shaped axes (every pixel drawn), 'flat' for (H+1, W+1)
        # corner grids (default_axes).
        a.pcolormesh(xa, ya, img, shading="auto", **kw)
        a.invert_yaxis()
        a.title.set_text(name)
    i = len(panels)
    if confusion is not None:
        a = ax[i // 2, i % 2]
        a.imshow(confusion, interpolation="nearest", cmap="ocean")
        a.set_ylabel("True label")
        a.set_xlabel("Predicted label")
        a.title.set_text("Confusion Matrix")
        i += 1
    for j in range(i, rows * 2):
        ax[j // 2, j % 2].axis("off")

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def render_input_channels(out_dir: str, x: np.ndarray,
                          prefix: str = "input") -> list:
    """Dump each input channel as a PNG (reference: TBIEvaluator.py:261-273
    DispInput)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for c in range(x.shape[-1]):
        fig, a = plt.subplots()
        a.grid(False)
        a.imshow(x[..., c], cmap="winter")
        p = os.path.join(out_dir, f"{prefix}_{c}.png")
        fig.savefig(p)
        plt.close(fig)
        paths.append(p)
    return paths
